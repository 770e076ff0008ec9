"""Port parity: the KRR fit as a whole (repro_torch.core.krr.fit).

The JAX reference fits regression with 1-D y, binary and multiclass
classification (float64, under its ``xla`` backend and its Pallas kernels
in interpret mode); the port fits the same data on the CPU with the
reference's random draws injected: the padding rows and noise and the
landmark rows from its key chain, the directions from its tree.  n = 500
is not a multiple of the leaf, so the fit pads to 512.  ``alpha``, the
plan, the cached inverse and the predictions must agree to 1e-10
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws
from test_torch_oos import flatten_model

from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch import convert
from repro_torch.core import hck, hmatrix, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import auto_levels, auto_levels_ceil

N, D, RANK, LEAF = 500, 3, 8, 16
SIGMA, JITTER, LAM = 1.5, 1e-8, 1e-2
TASKS = ["regression", "binary", "multiclass"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _data(task, seed=12):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D))
    score = np.sin(x).sum(axis=1)
    if task == "regression":
        y = score
    elif task == "binary":
        y = np.where(score > 0, 1, -1)
    else:
        y = np.digitize(score, [-0.8, 0.8])        # labels 0, 1, 2
    return x, y, rng.standard_normal((61, D))


def reference_draws(key, x, leaf, levels, rank):
    """The padding rows, padding noise and landmark rows that
    ``repro.core.krr.fit`` draws from ``key``."""
    n, d = x.shape
    extra = leaf * (1 << levels) - n
    kpad, kbuild = jax.random.split(key)
    k1, k2 = jax.random.split(kpad)
    return dict(
        pad_index=_t(jax.random.randint(k1, (extra,), 0, n)),
        pad_noise=_t(1e-4 * jax.random.normal(k2, (extra, d),
                                              dtype=jnp.float64)),
        landmark_index=landmark_draws(kbuild, leaf << levels, levels, rank))


@pytest.fixture(scope="module", params=["xla", "pallas"])
def fitted(request, f64):
    """Per task: (reference model, port model fitted on the CPU, queries)."""
    cfg = JSolveConfig(backend=request.param, interpret=True)
    key = jax.random.PRNGKey(3)
    out = {}
    for task in TASKS:
        x, y, q = _data(task)
        cls = task != "regression"
        m = jkrr.fit(jnp.asarray(x), jnp.asarray(y), kernel=JKernel(
            "gaussian", SIGMA, JITTER), lam=LAM, rank=RANK, leaf_size=LEAF,
            key=key, classification=cls, solve_config=cfg)
        pm = krr.fit(x, y, kernel=BaseKernel("gaussian", SIGMA, JITTER),
                     lam=LAM, rank=RANK, leaf_size=LEAF, classification=cls,
                     device="cpu",
                     directions=[_t(v) for v in m.factors.tree.directions],
                     **reference_draws(key, x, LEAF, m.factors.levels, RANK))
        out[task] = (m, pm, q)
    return out


@pytest.mark.parametrize("task", TASKS)
def test_fit_matches_reference(fitted, task):
    m, pm, q = fitted[task]
    assert pm.factors.n == 512 and pm.factors.levels == 5
    np.testing.assert_array_equal(pm.factors.tree.perm.numpy(),
                                  np.asarray(m.factors.tree.perm))
    _close(pm.alpha, m.alpha)
    _close(pm.plan.w_leaf, m.plan.w_leaf)
    _close(pm.plan.c_tilde, m.plan.c_tilde)
    _close(pm.predict(_t(q)), m.predict(jnp.asarray(q)))
    assert pm.squeeze == m.squeeze and pm.lam == LAM
    if task == "regression":
        assert pm.classes is None and pm.predict(_t(q)).ndim == 1
    else:
        np.testing.assert_array_equal(pm.classes.numpy(),
                                      np.asarray(m.classes))
        np.testing.assert_array_equal(pm.predict_class(_t(q)).numpy(),
                                      np.asarray(m.predict_class(
                                          jnp.asarray(q))))


@pytest.mark.parametrize("task", TASKS)
def test_fit_caches_the_inverse_and_leaf_factor(fitted, task):
    m, pm, _ = fitted[task]
    assert pm.base_leaf_size == LEAF
    _close(pm.leaf_lo, m.leaf_lo)
    for field in ("adiag", "u", "linv", "logabsdet"):
        _close(getattr(pm.inverse, field), getattr(m.inverse, field))
    for field in ("sigma", "w"):
        for got, want in zip(getattr(pm.inverse, field),
                             getattr(m.inverse, field)):
            _close(got, want)
    # convert carries a reference fit's cache across unchanged
    arrays = flatten_model(m.factors, m.plan, m.alpha, m.classes, m.inverse,
                           m.leaf_lo)
    cm = convert.regressor_from_arrays(arrays, kernel="gaussian",
                                       sigma=SIGMA, jitter=JITTER, lam=LAM,
                                       squeeze=m.squeeze, device="cpu")
    _close(cm.leaf_lo, m.leaf_lo, 0)
    _close(cm.inverse.linv, m.inverse.linv, 0)
    for got, want in zip(cm.inverse.sigma, m.inverse.sigma):
        _close(got, want, 0)
    assert cm.base_leaf_size == LEAF and cm.lam == LAM


def test_fit_without_device_runs_on_the_card_or_raises(monkeypatch, f64):
    x, y, _ = _data("regression")
    kw = dict(kernel=BaseKernel(), lam=LAM, rank=RANK, leaf_size=LEAF)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="is_available"):
            krr.fit(x, y, device=device, **kw)
    model = krr.fit(x, y, device="cpu", **kw)
    assert model.alpha.device.type == "cpu"
    assert model.alpha.shape == (512, 1)


def test_fit_from_the_generator_alone(f64):
    """The port's own draws: balanced leaves, r distinct landmark rows per
    node, and a solve whose residual against the dense oracle is at most
    1e-8.  Default kernel (sigma 1, jitter 1e-5) on d = 6 points."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((N, 6))
    y = np.cos(x).sum(axis=1)
    gen = torch.Generator().manual_seed(7)
    model = krr.fit(x, y, kernel=BaseKernel(), lam=LAM, rank=RANK,
                    leaf_size=LEAF, device="cpu", generator=gen)
    f = model.factors
    assert f.n == 512 and f.levels == auto_levels_ceil(N, LEAF) == 5
    assert auto_levels(N, LEAF) == 4
    # balanced: every leaf holds n0 points, each training row once
    counts = torch.bincount(f.tree.perm[f.tree.perm < N], minlength=N)
    assert (counts == 1).all()
    for lvl, lm in enumerate(f.landmarks):
        for node in range(1 << lvl):
            assert torch.unique(lm[node], dim=0).shape[0] == RANK
    # targets in tree order: a padding row copies the target of the real row
    # it perturbs (noise 1e-4), found here as its nearest real point
    src = torch.cdist(f.x_sorted, _t(x)).argmin(dim=1)
    real = f.tree.perm < N
    assert torch.equal(src[real], f.tree.perm[real])
    want = _t(y)[src]
    got = ((hck.to_dense(f) + LAM * torch.eye(f.n)) @ model.alpha)[:, 0]
    assert (torch.linalg.vector_norm(got - want)
            <= 1e-8 * torch.linalg.vector_norm(want))
    assert torch.isfinite(model.predict(_t(x[:20]))).all()


def test_unported_fit_options_raise():
    """No fit option raises any more: ``solve_config.precision`` (ROADMAP
    A15a) fits, its factors, alpha and predictions in the policy's factor
    dtype and the model keeping its config (the bounds against the
    reference are in test_torch_mixed_precision.py); the A10 options fit
    (held against the reference in test_torch_landmarks.py)."""
    x, y, _ = _data("regression")
    from repro_torch.kernels.registry import SolveConfig
    for prec, dt in (("bf16", torch.float32), ("f32", torch.float32),
                     ("f64", torch.float64)):
        cfg = SolveConfig(precision=prec)
        m = krr.fit(x, y, kernel=BaseKernel(), lam=LAM, rank=RANK,
                    leaf_size=LEAF, device="cpu", solve_config=cfg)
        assert m.solve_config is cfg and m.alpha.dtype == dt
        assert m.factors.x_sorted.dtype == torch.float64
        z = m.predict(torch.as_tensor(x[:20]))
        assert z.dtype == dt and torch.isfinite(z).all()
    for kw in (dict(landmarks="kmeans"), dict(rank_budget=50),
               dict(shared_landmarks=True), dict(method="pca")):
        m = krr.fit(x, y, kernel=BaseKernel(), lam=LAM, rank=RANK,
                    leaf_size=LEAF, device="cpu", **kw)
        assert torch.isfinite(m.alpha).all()
    f = krr.fit(x[:64], y[:64], kernel=BaseKernel(), lam=LAM, rank=4,
                leaf_size=16, levels=2, device="cpu").factors
    assert f.levels == 2 and isinstance(f, hck.HCKFactors)
    assert isinstance(krr.fit(x[:64], y[:64], kernel=BaseKernel(), lam=LAM,
                              rank=4, device="cpu").inverse,
                      hmatrix.InverseFactors)
