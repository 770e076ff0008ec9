"""Port parity for the serving slice as a whole.

The JAX reference fits KRR (regression with 1-D y, binary and multiclass
classification) under its ``xla`` backend and under its Pallas kernels in
interpret mode; the fitted model goes through ``repro_torch.convert``, and
the port predicts on the CPU through ``HCKRegressor.predict`` /
``predict_class`` and ``PredictEngine``.  In float64 the predictions must
agree to 1e-10 relative, and the engine's serving counters must agree for
batches that pad and batches that micro-batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_oos import flatten_model

from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.serving import predict_service as jserve
from repro_torch import convert
from repro_torch.serving import predict_service as serve

N, D, RANK, LEAF = 512, 3, 8, 16
SIGMA, JITTER, LAM = 1.5, 1e-8, 1e-2
TASKS = ["regression", "binary", "multiclass"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _data(task):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D))
    score = np.sin(x).sum(axis=1)
    if task == "regression":
        y = score
    elif task == "binary":
        y = np.where(score > 0, 1, -1)
    else:
        y = np.digitize(score, [-0.8, 0.8])        # labels 0, 1, 2
    return x, y, rng.standard_normal((77, D))


@pytest.fixture(scope="module", params=["xla", "pallas"])
def fitted(request, f64):
    """Per task: (reference model, port model on the CPU, queries)."""
    cfg = JSolveConfig(backend=request.param, interpret=True)
    out = {}
    for task in TASKS:
        x, y, q = _data(task)
        m = jkrr.fit(jnp.asarray(x), jnp.asarray(y), kernel=JKernel(
            "gaussian", SIGMA, JITTER), lam=LAM, rank=RANK, leaf_size=LEAF,
            key=jax.random.PRNGKey(2), classification=task != "regression",
            solve_config=cfg)
        arrays = flatten_model(m.factors, m.plan, m.alpha, m.classes)
        pm = convert.regressor_from_arrays(
            arrays, kernel="gaussian", sigma=SIGMA, jitter=JITTER,
            squeeze=m.squeeze, device="cpu")
        out[task] = (m, pm, q)
    return out


@pytest.mark.parametrize("task", TASKS)
def test_predict_matches_reference_fit(fitted, task):
    m, pm, q = fitted[task]
    want = m.predict(jnp.asarray(q))
    got = pm.predict(_t(q))
    assert got.shape == want.shape
    _close(got, want)
    if task != "regression":
        np.testing.assert_array_equal(pm.predict_class(_t(q)).numpy(),
                                      np.asarray(m.predict_class(jnp.asarray(q))))
    else:
        with pytest.raises(ValueError, match="regression"):
            pm.predict_class(_t(q))


@pytest.mark.parametrize("task", TASKS)
def test_engine_from_weights_matches_reference(fitted, task):
    m, pm, q = fitted[task]
    want = jserve.PredictEngine.from_weights(m.factors, m.alpha, m.kernel)(
        jnp.asarray(q))
    eng = serve.PredictEngine.from_weights(pm.factors, pm.alpha, pm.kernel)
    _close(eng(_t(q)), want)


def test_engine_stats_match_across_padding_and_micro_batching(fitted):
    m, pm, q = fitted["multiclass"]
    jeng = jserve.PredictEngine(m.factors, m.plan, m.kernel, min_bucket=8,
                                max_bucket=32)
    eng = serve.PredictEngine(pm.factors, pm.plan, pm.kernel, min_bucket=8,
                              max_bucket=32)
    for size in (1, 5, 8, 20, 33, 77):
        _close(eng(_t(q[:size])), jeng(jnp.asarray(q[:size])))
    assert eng(_t(q[:0])).shape == jeng(jnp.asarray(q[:0])).shape == (0, 3)
    assert eng.stats == jeng.stats
    assert eng.stats["bucket_hits"] == {8: 4, 16: 1, 32: 4}
    assert eng.warmup() == jeng.warmup() == [8, 16, 32]
    assert eng.stats == jeng.stats


def test_engine_rejects_malformed_batches(fitted):
    _, pm, q = fitted["regression"]
    eng = pm.engine
    with pytest.raises(ValueError, match="2-D"):
        eng(_t(q[0]))
    with pytest.raises(ValueError, match="feature dim"):
        eng(_t(q[:, :2]))
    with pytest.raises(ValueError, match="0 features"):
        eng(torch.zeros(3, 0, dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        eng(_t(q).float())
    assert eng(_t(q[:0])).shape == (0, 1)


@pytest.mark.parametrize("q,lo,hi", [(1, 64, 4096), (64, 64, 4096),
                                     (65, 64, 4096), (5000, 64, 4096),
                                     (3, 1, 2)])
def test_bucket_size_matches_reference(q, lo, hi):
    assert serve.bucket_size(q, lo, hi) == jserve.bucket_size(q, lo, hi)
    with pytest.raises(ValueError):
        serve.bucket_size(0, lo, hi)


def test_convert_refuses_budgeted_rank_and_missing_arrays(fitted):
    """Budgeted-rank factors now carry across with their masks (ported with
    A10; a budgeted reference model is served in test_torch_landmarks.py);
    an incomplete set of arrays is still refused."""
    m, _, _ = fitted["regression"]
    arrays = flatten_model(m.factors, m.plan, m.alpha)
    masks = {f"rank_mask/{lvl}": np.ones((1 << lvl, 8))
             for lvl in range(m.factors.levels)}
    f = convert.factors_from_arrays({**arrays, **masks}, device="cpu")
    assert len(f.rank_mask) == m.factors.levels
    assert f.ranks.total == 8 * ((1 << m.factors.levels) - 1)
    del arrays["sigma_cho/2"]
    with pytest.raises(KeyError, match="sigma_cho/2"):
        convert.factors_from_arrays(arrays, device="cpu")
