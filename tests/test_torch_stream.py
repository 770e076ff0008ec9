"""Port parity: streamed ingestion (repro_torch.data.pipeline,
hck.build_hck_streaming, krr.fit_streaming) against the JAX reference.

The reference runs in float64 at the sizes of its own streaming tests
(``tests/test_build_engine.py``); the port runs on the CPU with the
reference's draws injected: its pad rows and noise, its directions (read
off its tree) and its landmark rows.  Without injected draws the port's
streamed path must equal its own in-memory path on the same generator:
the same pad rows, tree and landmarks, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws

from repro.core import hck as jhck
from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.core.partition import build_partition as j_build_partition
from repro.data import pipeline as jpipe
from repro_torch.configs.hck_krr import DATASETS, HCKConfig
from repro_torch.core import hck, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import build_partition, pad_points
from repro_torch.data import pipeline


def _t(a):
    return torch.from_numpy(np.array(a))


def _dirs(tree):
    return [_t(v) for v in tree.directions]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.size:
        assert np.abs(got - want).max() <= tol, np.abs(got - want).max()


def _rclose(got, want, rtol):
    """max |got - want| <= rtol * max |want|."""
    want = np.asarray(want)
    _close(got, want, rtol * np.abs(want).max())


def _factors_close(got, want, tol):
    """Port factors against reference (or port) factors: points and tree
    exact, every factor within ``tol``."""
    np.testing.assert_array_equal(np.asarray(got.x_sorted),
                                  np.asarray(want.x_sorted))
    np.testing.assert_array_equal(np.asarray(got.tree.perm),
                                  np.asarray(want.tree.perm))
    _close(got.adiag, want.adiag, tol)
    _close(got.u, want.u, tol)
    for name in ("landmarks", "sigma", "sigma_cho", "w"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            _close(a, b, tol)


# ---------------------------------------------------------------------------
# sources and padding
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def padded(f64):
    """37 rows of d 4 padded to 64 (leaf 8, 3 levels) by both packages
    from the reference's key: (reference source, y, mask; port's)."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(11), (37, 4),
                                     dtype=jnp.float64))
    y = np.asarray(jax.random.normal(jax.random.PRNGKey(12), (37,),
                                     dtype=jnp.float64))
    key = jax.random.PRNGKey(13)
    ref = jpipe.pad_source(jpipe.ArraySource(x), y, 8, 3, key)
    k1, k2 = jax.random.split(key)
    index = _t(jax.random.randint(k1, (27,), 0, 37))
    noise = _t(1e-4 * jax.random.normal(k2, (27, 4), dtype=jnp.float64))
    port = pipeline.pad_source(pipeline.ArraySource(x), y, 8, 3,
                               index=index, noise=noise)
    return x, y, index, noise, ref, port


def test_pad_source_matches_reference(padded):
    x, y, index, noise, (src, ys, mask), (psrc, pys, pmask) = padded
    assert psrc.n == src.n == 64 and psrc.dim == 4
    assert psrc.dtype == src.dtype
    np.testing.assert_array_equal(pmask, mask)
    _close(psrc.chunk(0, 64), src.chunk(0, 64), 1e-15)
    np.testing.assert_array_equal(pys, ys)
    # and exactly what the port's in-memory padding makes of the same draws
    xp, yp, mp = pad_points(_t(x), _t(y), 8, 3, index=index, noise=noise)
    np.testing.assert_array_equal(psrc.chunk(0, 64), xp.numpy())
    np.testing.assert_array_equal(pys, yp.numpy())
    np.testing.assert_array_equal(pmask, mp.numpy())
    # a tensor y is padded on its device, as pad_points pads it
    _, yt, _ = pipeline.pad_source(pipeline.ArraySource(x), _t(y), 8, 3,
                                   index=index, noise=noise)
    assert isinstance(yt, torch.Tensor) and torch.equal(yt, yp)


@pytest.mark.parametrize("rows", [(0, 5), (30, 37), (35, 40), (37, 37),
                                  (37, 45), (60, 64), (0, 64)],
                         ids=lambda r: f"{r[0]}-{r[1]}")
def test_padded_source_chunk_across_the_boundary(padded, rows):
    *_, (src, _, _), (psrc, _, _) = padded
    got, want = psrc.chunk(*rows), src.chunk(*rows)
    assert got.shape == want.shape == (rows[1] - rows[0], 4)
    _close(got, want, 1e-15)


@pytest.mark.parametrize("rows", [[0, 36, 37, 63], [63, 0], [40, 41, 2],
                                  []], ids=str)
def test_padded_source_take_across_the_boundary(padded, rows):
    x, *_, (src, _, _), (psrc, _, _) = padded
    rows = np.array(rows, dtype=np.int64)
    got = psrc.take(rows)
    assert got.shape == (len(rows), 4)
    _close(got, src.take(rows), 1e-15)
    base = rows[rows < 37]
    np.testing.assert_array_equal(got[rows < 37], x[base])


def test_array_source_contract(f64):
    x = np.arange(12.0).reshape(6, 2)
    src = pipeline.ArraySource(_t(x))
    ref = jpipe.ArraySource(x)
    assert (src.n, src.dim, src.dtype) == (ref.n, ref.dim, ref.dtype)
    np.testing.assert_array_equal(src.chunk(1, 4), ref.chunk(1, 4))
    np.testing.assert_array_equal(src.take(np.array([5, 0])),
                                  ref.take(np.array([5, 0])))
    assert pipeline.torch_dtype(src) == torch.float64
    with pytest.raises(ValueError):
        pipeline.ArraySource(np.zeros(3))
    # an exact-size input round-trips unchanged
    same, ys, mask = pipeline.pad_source(src, None, 3, 1)
    assert same is src and ys is None and mask.all()


# ---------------------------------------------------------------------------
# stream_partition
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def partition_case(f64):
    """The reference's stream_partition test: x (128, 4), 3 levels."""
    x = jax.random.normal(jax.random.PRNGKey(6), (128, 4), dtype=jnp.float64)
    _, tree = j_build_partition(x, 3, jax.random.PRNGKey(7))
    return np.asarray(x), tree


@pytest.mark.parametrize("chunk_rows", [17, 23, 128, 1 << 16])
def test_stream_partition_matches_reference(partition_case, chunk_rows):
    x, tree = partition_case
    jperm, jtree = jpipe.stream_partition(jpipe.ArraySource(x), 3,
                                          jax.random.PRNGKey(7),
                                          chunk_rows=chunk_rows)
    perm, ptree = pipeline.stream_partition(
        pipeline.ArraySource(x), 3, directions=_dirs(tree), device="cpu",
        chunk_rows=chunk_rows)
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(ptree.perm.numpy(), perm)
    for got, want in zip(ptree.thresholds, jtree.thresholds):
        _close(got, want, 1e-14)
    # bit for bit the port's in-memory partition on the same directions
    xs, mtree = build_partition(_t(x), 3, directions=_dirs(tree))
    assert torch.equal(ptree.perm, mtree.perm)
    for got, want in zip(ptree.thresholds, mtree.thresholds):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(x[perm], xs.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=str)
def test_stream_partition_equals_build_partition_on_a_generator(dtype):
    """The port's own draws: the same generator gives the same directions,
    permutation and thresholds, bit for bit, in f32 and f64, with chunks
    that end inside nodes."""
    x = torch.randn((1024, 7), generator=torch.Generator().manual_seed(3),
                    dtype=dtype)
    _, tree = build_partition(x, 5,
                              generator=torch.Generator().manual_seed(4))
    perm, stree = pipeline.stream_partition(
        pipeline.ArraySource(x), 5, chunk_rows=97,
        generator=torch.Generator().manual_seed(4))
    assert torch.equal(stree.perm, tree.perm)
    np.testing.assert_array_equal(perm, tree.perm.numpy())
    for name in ("directions", "thresholds"):
        for got, want in zip(getattr(stree, name), getattr(tree, name)):
            assert got.dtype == dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# build_hck_streaming and fit_streaming
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def build_case(f64):
    """The reference's streaming-equality test: x (256, 5), 3 levels,
    rank 8, leaf_batch 3, chunk_rows 23; its streamed factors."""
    x = jax.random.normal(jax.random.PRNGKey(4), (256, 5), dtype=jnp.float64)
    ker = JKernel("gaussian", sigma=2.0, jitter=1e-8)
    key = jax.random.PRNGKey(5)
    jf = jhck.build_hck_streaming(jpipe.ArraySource(np.asarray(x)),
                                  levels=3, rank=8, key=key, kernel=ker,
                                  leaf_batch=3, chunk_rows=23)
    return np.asarray(x), key, jf


@pytest.mark.parametrize("leaf_batch", [3, 8])
def test_build_hck_streaming_matches_reference(build_case, leaf_batch):
    x, key, jf = build_case
    ker = BaseKernel("gaussian", sigma=2.0, jitter=1e-8)
    draws = dict(directions=_dirs(jf.tree),
                 landmark_index=landmark_draws(key, 256, 3, 8))
    timings = {}
    f = hck.build_hck_streaming(
        pipeline.ArraySource(x), levels=3, rank=8, kernel=ker,
        leaf_batch=leaf_batch, chunk_rows=23, device="cpu", timings=timings,
        **draws)
    _factors_close(f, jf, 1e-12)
    assert {"partition level 2", "landmarks", "leaf groups",
            "transfer W"} <= set(timings)
    # and the port's in-memory build on the same draws
    fm = hck.build_hck(_t(x), levels=3, rank=8, kernel=ker, **draws)
    _factors_close(f, fm, 1e-12)
    assert torch.equal(f.adiag, fm.adiag)


@pytest.fixture(scope="module")
def fit_case(f64):
    """The reference's padding case: n 147 padded to 160 (leaf 10, 4
    levels), its streamed fit."""
    n = 147
    x = jax.random.normal(jax.random.PRNGKey(8), (n, 3), dtype=jnp.float64)
    y = jnp.sin(x[:, 0]) + 0.1 * x[:, 1]
    ker = JKernel("gaussian", sigma=1.5, jitter=1e-8)
    key = jax.random.PRNGKey(9)
    opts = dict(kernel=ker, lam=1e-2, rank=8, leaf_size=10, key=key)
    ms = jkrr.fit_streaming(jpipe.ArraySource(np.asarray(x)), y,
                            leaf_batch=3, chunk_rows=19, **opts)
    q = jax.random.normal(jax.random.PRNGKey(10), (7, 3), dtype=jnp.float64)
    return np.asarray(x), np.asarray(y), key, ms, np.asarray(q)


def _reference_draws(key, n, d, leaf, levels, rank):
    kpad, kbuild = jax.random.split(key)
    k1, k2 = jax.random.split(kpad)
    extra = leaf * (1 << levels) - n
    return dict(
        pad_index=_t(jax.random.randint(k1, (extra,), 0, n)),
        pad_noise=_t(1e-4 * jax.random.normal(k2, (extra, d),
                                              dtype=jnp.float64)),
        landmark_index=landmark_draws(kbuild, leaf << levels, levels, rank))


def test_fit_streaming_matches_reference(fit_case):
    x, y, key, ms, q = fit_case
    pm = krr.fit_streaming(
        pipeline.ArraySource(x), y, kernel=BaseKernel("gaussian", 1.5, 1e-8),
        lam=1e-2, rank=8, leaf_size=10, leaf_batch=3, chunk_rows=19,
        device="cpu", directions=_dirs(ms.factors.tree),
        **_reference_draws(key, 147, 3, 10, 4, 8))
    assert pm.factors.n == 160 and pm.factors.levels == 4
    np.testing.assert_array_equal(pm.factors.tree.perm.numpy(),
                                  np.asarray(ms.factors.tree.perm))
    _close(pm.alpha, ms.alpha, 1e-10)
    _close(pm.predict(_t(q)), ms.predict(jnp.asarray(q)), 1e-10)
    assert pm.squeeze and pm.lam == 1e-2 and pm.base_leaf_size == 10
    # the cached inverse and leaf factor, as the reference caches them
    _close(pm.leaf_lo, ms.leaf_lo, 1e-10)
    _close(pm.inverse.linv, ms.inverse.linv, 1e-10)


@pytest.mark.parametrize("task", ["regression", "binary"])
def test_fit_streaming_equals_fit_on_one_generator(task):
    """Without injected draws: the same generator pads, partitions and
    picks landmarks alike, so the streamed model is the in-memory one, and
    it takes an online update as the in-memory one does."""
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((147, 3), generator=gen, dtype=torch.float64)
    y = torch.sin(x[:, 0]) + 0.1 * x[:, 1]
    if task == "binary":
        y = (y > 0).to(torch.int64)
    opts = dict(kernel=BaseKernel("gaussian", 1.5, 1e-8), lam=1e-2, rank=8,
                leaf_size=10, device="cpu",
                classification=task == "binary")
    m = krr.fit(x, y, generator=torch.Generator().manual_seed(5), **opts)
    ms = krr.fit_streaming(pipeline.ArraySource(x), y, leaf_batch=3,
                           chunk_rows=19,
                           generator=torch.Generator().manual_seed(5), **opts)
    fa, fb = m.factors, ms.factors
    assert torch.equal(fa.tree.perm, fb.tree.perm)
    assert torch.equal(fa.x_sorted, fb.x_sorted)      # the pad rows too
    for a, b in zip(fa.landmarks + fa.tree.thresholds,
                    fb.landmarks + fb.tree.thresholds):
        assert torch.equal(a, b)
    for name in ("adiag", "sigma", "sigma_cho"):
        for a, b in zip(*(torch.atleast_3d(getattr(f, name)) if name ==
                          "adiag" else getattr(f, name) for f in (fa, fb))):
            assert torch.equal(a, b), name
    # U and W come from B2's plain products in other launch shapes (leaf
    # groups of 3 against sibling pairs), whose round-off kappa(Sigma)
    # amplifies near the duplicated pad rows: 8.5e-10 here
    _factors_close(fb, fa, 1e-8)
    _rclose(ms.alpha, m.alpha, 1e-10)
    q = torch.randn((9, 3), generator=gen, dtype=torch.float64)
    _rclose(ms.predict(q), m.predict(q), 1e-10)
    assert ms.inverse is not None and ms.leaf_lo is not None
    xu = torch.randn((12, 3), generator=gen, dtype=torch.float64)
    yu = (torch.sin(xu[:, 0]) if task == "regression"
          else (xu[:, 0] > 0).to(torch.int64))
    (mu, _), (msu, _) = (
        mod.update(xu, yu, generator=torch.Generator().manual_seed(6))
        for mod in (m, ms))
    _rclose(msu.alpha, mu.alpha, 1e-9)
    _rclose(msu.predict(q), mu.predict(q), 1e-9)


def test_fit_streaming_is_an_entry_point():
    assert getattr(krr.fit_streaming, "full_f32", False)


# ---------------------------------------------------------------------------
# the reference's errors
# ---------------------------------------------------------------------------

def _src(n=64, d=3):
    return np.random.default_rng(0).standard_normal((n, d))


ERRORS = {
    "kmeans policy": (ValueError, "uniform landmark policy",
                      dict(policy="kmeans")),
    "rank budget": (ValueError, "rank_budget", dict(rank_budget=20)),
    "no levels": (ValueError, "levels >= 1", dict(levels=0)),
    "rank above leaf": (ValueError, "exceeds leaf size", dict(rank=16)),
    "pca": (NotImplementedError, "method='rp' only", dict(method="pca")),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_build_hck_streaming_raises_as_the_reference(f64, case):
    exc, match, kw = ERRORS[case]
    kwargs = {"levels": 3, "rank": 4, **kw}
    with pytest.raises(exc, match=match):
        jhck.build_hck_streaming(jpipe.ArraySource(_src()),
                                 key=jax.random.PRNGKey(0),
                                 kernel=JKernel(), **kwargs)
    with pytest.raises(exc, match=match):
        hck.build_hck_streaming(pipeline.ArraySource(_src()),
                                kernel=BaseKernel(), device="cpu", **kwargs)


def test_streaming_input_errors():
    src = pipeline.ArraySource(_src(60))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.stream_partition(src, 3, device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        pipeline.stream_partition(src, 2, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="levels >= 1"):
        pipeline.pad_source(src, None, 8, 0, device="cpu")
    with pytest.raises(ValueError, match="exceeds capacity"):
        pipeline.pad_source(src, None, 4, 3, device="cpu")
    with pytest.raises(ValueError, match="2 directions for 3 levels"):
        pipeline.stream_partition(pipeline.ArraySource(_src(64)), 3,
                                  device="cpu",
                                  directions=[torch.ones(1, 3)] * 2)
    from repro_torch.kernels.registry import SolveConfig

    f = hck.build_hck_streaming(pipeline.ArraySource(_src(64)), levels=2,
                                rank=4, kernel=BaseKernel(), device="cpu",
                                config=SolveConfig(precision="f32"))
    assert f.u.dtype == f.adiag.dtype == torch.float32
    assert f.x_sorted.dtype == f.landmarks[0].dtype == torch.float64


# ---------------------------------------------------------------------------
# regression_dataset
# ---------------------------------------------------------------------------

def _reference_dataset_draws(cfg, key):
    kx, kc, kw, kn, kt = jax.random.split(key, 5)
    return {"x": _t(jax.random.uniform(kx, (cfg.n_train, cfg.d))),
            "x_test": _t(jax.random.uniform(kt, (cfg.n_test, cfg.d))),
            "centers": _t(jax.random.uniform(kc, (32, cfg.d))),
            "weights": _t(jax.random.normal(kw, (32,))),
            "noise": _t(jax.random.normal(kn, (cfg.n_train,)))}


@pytest.mark.parametrize("task", ["regression", "binary", "multiclass"])
def test_regression_dataset_matches_reference(f64, task):
    cfg = HCKConfig(f"toy-{task}", 301, 77, 6, task,
                    n_classes=4 if task == "multiclass" else 0)
    key = jax.random.PRNGKey(17)
    (jx, jy), (jxt, jyt) = jpipe.regression_dataset(cfg, key)
    (x, y), (xt, yt) = pipeline.regression_dataset(
        cfg, device="cpu", dtype=torch.float64, chunk_rows=37,
        draws=_reference_dataset_draws(cfg, key))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jxt))
    if task == "regression":
        _close(y, jy, 1e-12)
        _close(yt, jyt, 1e-12)
    else:
        assert y.dtype == yt.dtype == torch.int32
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(yt.numpy(), np.asarray(jyt))


def test_regression_dataset_from_a_generator():
    cfg = DATASETS["susy"]
    small = HCKConfig("susy-small", 2000, 500, cfg.d, cfg.task)
    gen = torch.Generator().manual_seed(0)
    (x, y), (xt, yt) = pipeline.regression_dataset(small, generator=gen,
                                                   chunk_rows=300)
    assert x.shape == (2000, 18) and xt.shape == (500, 18)
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    assert int(y.sum()) == 1000          # the median threshold halves it
    assert 0.3 < float(yt.float().mean()) < 0.7
    # the draws' order: x, x_test, centers, weights, noise
    again = torch.Generator().manual_seed(0)
    assert torch.equal(torch.rand((2000, 18), generator=again), x)
    assert (cfg.n_train, cfg.n_test, cfg.rank, cfg.leaf_size) == (
        4_000_000, 1_000_000, 128, 128)
