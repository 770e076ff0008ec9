"""Port parity: the Gaussian-process module (repro_torch.core.gp).

``fit_gp`` and the ``HCKGaussianProcess`` methods, ``mle_objective``
(value and, on the CPU, gradient) and ``mle_grid`` (exact log-determinant)
go through the JAX reference in float64 and through the port's plain
PyTorch path on the CPU, with the reference's tree and landmark draws
injected.  Tolerance 1e-10 relative unless a line says otherwise.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws
from test_torch_oos import flatten_model

from repro.core import gp as jgp
from repro.core import hck as jhck
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch import convert
from repro_torch.core import gp, hck
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build

N, D, RANK, LEVELS = 512, 3, 8, 5
SIGMA, JITTER, NOISE = 1.5, 1e-8, 1e-2
SIGMAS, NOISES = (0.8, 1.6), (1e-2, 1e-1, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def _close_mean(got, want, model, queries, rtol=1e-10):
    """The posterior mean sum_i alpha_i k_hck(x_i, q) cancels (|alpha| runs
    to ~30 for predictions ~1 at noise 1e-2), so it is held to rtol times
    the sum of the terms' magnitudes, |alpha|^T |k_hck(X, q)|, per query."""
    from repro_torch.core.oos import oos_reference_batch

    terms = (oos_reference_batch(model.factors, _t(queries),
                                 model.kernel).abs()
             @ model.alpha.abs())[:, 0]
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= rtol * terms.numpy()).all(), (err / terms.numpy()).max()


@pytest.fixture(scope="module")
def problem(f64):
    """(x, y, queries, key, the reference's draws for the port)."""
    rng = np.random.default_rng(30)
    x = rng.standard_normal((N, D))
    y = np.sin(2 * x[:, 0]) + 0.3 * x[:, 1] + 0.1 * rng.standard_normal(N)
    key = jax.random.PRNGKey(31)
    jf = jhck.build_hck(jnp.asarray(x), levels=LEVELS, rank=RANK, key=key,
                        kernel=JKernel("gaussian", SIGMA, JITTER))
    draws = dict(directions=[_t(v) for v in jf.tree.directions],
                 landmark_index=landmark_draws(key, N, LEVELS, RANK))
    return x, y, rng.standard_normal((12, D)), key, draws


@pytest.fixture(scope="module", params=["xla", "pallas"])
def gps(request, problem):
    """(reference GP, port GP fitted on the CPU)."""
    x, y, _, key, draws = problem
    m = jgp.fit_gp(jnp.asarray(x), jnp.asarray(y),
                   kernel=JKernel("gaussian", SIGMA, JITTER), noise=NOISE,
                   rank=RANK, levels=LEVELS, key=key,
                   solve_config=JSolveConfig(backend=request.param,
                                             interpret=True))
    pm = gp.fit_gp(x, y, kernel=BaseKernel("gaussian", SIGMA, JITTER),
                   noise=NOISE, rank=RANK, levels=LEVELS, device="cpu",
                   **draws)
    return m, pm


def test_fit_gp_matches_reference(gps):
    m, pm = gps
    np.testing.assert_array_equal(pm.factors.tree.perm.numpy(),
                                  np.asarray(m.factors.tree.perm))
    _close(pm.alpha, m.alpha)
    _close(pm.inv.logabsdet, m.inv.logabsdet)
    _close(pm.plan.c_tilde, m.plan.c_tilde)
    assert pm.noise == NOISE and pm.alpha.shape == (N, 1)


def test_gp_posterior_matches_reference(gps, problem):
    m, pm = gps
    _, y, q, _, _ = problem
    _close_mean(pm.posterior_mean(_t(q)), m.posterior_mean(jnp.asarray(q)),
                pm, q)
    # the variance is kxx minus a nearly equal quadratic form
    _close(pm.posterior_var(_t(q)), m.posterior_var(jnp.asarray(q)), 1e-8)
    y_sorted = jnp.asarray(y)[m.factors.tree.perm]
    _close(pm.log_marginal_likelihood(_t(y_sorted)),
           m.log_marginal_likelihood(y_sorted))


def test_gp_carried_across(gps, problem):
    """A reference GP carried across by convert predicts as it does."""
    m, _ = gps
    _, _, q, _, _ = problem
    arrays = flatten_model(m.factors, m.plan, alpha=m.alpha, inverse=m.inv)
    cm = convert.gp_from_arrays(arrays, kernel="gaussian", sigma=SIGMA,
                                jitter=JITTER, noise=NOISE, device="cpu")
    _close_mean(cm.posterior_mean(_t(q)), m.posterior_mean(jnp.asarray(q)),
                cm, q)
    _close(cm.posterior_var(_t(q)), m.posterior_var(jnp.asarray(q)), 1e-8)
    with pytest.raises(KeyError, match="inverse"):
        convert.gp_from_arrays(flatten_model(m.factors, m.plan,
                                             alpha=m.alpha),
                               kernel="gaussian", sigma=SIGMA, jitter=JITTER,
                               noise=NOISE, device="cpu")


@pytest.mark.parametrize("name", ["gaussian", "laplace"])
def test_mle_objective_value_and_gradient_match_reference(problem, name):
    """The value for both metrics; the gradient for gaussian (the
    reference compiles its whole build again for a gradient)."""
    x, y, _, key, draws = problem
    jnll = jgp.mle_objective(jnp.asarray(x), jnp.asarray(y), levels=LEVELS,
                             rank=RANK, key=key, name=name)
    nll = gp.mle_objective(x, y, levels=LEVELS, rank=RANK, name=name,
                           device="cpu", **draws)
    for point in ((0.2, np.log(0.05)), (-0.3, np.log(0.5))):
        _close(nll(*point), jnll(*map(jnp.asarray, point)))
    if name != "gaussian":
        return
    ls = torch.tensor(0.2, dtype=torch.float64, requires_grad=True)
    ln = torch.tensor(np.log(0.05), dtype=torch.float64, requires_grad=True)
    got = torch.autograd.grad(nll(ls, ln), (ls, ln))
    want = jax.grad(jnll, argnums=(0, 1))(jnp.asarray(0.2),
                                          jnp.asarray(np.log(0.05)))
    # autograd and jax.grad differentiate the Cholesky factors and the
    # solves through different formulas: 1e-8
    for g, w in zip(got, want):
        _close(g, w, 1e-8)


@pytest.fixture(scope="module")
def grids(problem):
    """(reference surface, port surface, port plan)."""
    x, y, _, key, draws = problem
    want = jgp.mle_grid(jnp.asarray(x), jnp.asarray(y), levels=LEVELS,
                        rank=RANK, key=key, sigmas=SIGMAS,
                        noises=jnp.asarray(NOISES))
    plan = hck.build_sweep_plan(x, levels=LEVELS, rank=RANK, device="cpu",
                                **draws)
    got = gp.mle_grid(x, y, levels=LEVELS, rank=RANK, sigmas=SIGMAS,
                      noises=NOISES, plan=plan, device="cpu")
    return want, got, plan


def test_mle_grid_matches_reference(grids, problem):
    want, got, _ = grids
    assert got.shape == (len(SIGMAS), len(NOISES))
    _close(got, want)
    x, y, _, _, draws = problem
    # the grid builds the same plan from the draws when none is given
    _close(gp.mle_grid(x, y, levels=LEVELS, rank=RANK, sigmas=SIGMAS,
                       noises=NOISES, device="cpu", **draws), want)


def test_mle_grid_against_dense_oracle_and_objective(grids, problem):
    """Every entry against (to_dense(f) + lam I) through slogdet and solve,
    and against mle_objective at (log sigma, log lam), whose build folds
    sigma into the data (round-off apart: 1e-8)."""
    _, got, plan = grids
    x, y, _, _, draws = problem
    nll = gp.mle_objective(x, y, levels=LEVELS, rank=RANK, device="cpu",
                           **draws)
    for s, sigma in enumerate(SIGMAS):
        f = hck.sweep_factors(plan, BaseKernel("gaussian", sigma, 1e-5))
        ys = _t(y)[f.tree.perm]
        a = hck.to_dense(f)
        for g, lam in enumerate(NOISES):
            k = a + lam * torch.eye(N, dtype=a.dtype)
            want = (0.5 * ys @ torch.linalg.solve(k, ys)
                    + 0.5 * torch.linalg.slogdet(k)[1]
                    + 0.5 * N * np.log(2 * np.pi))
            _close(got[s, g], want, 1e-8)
            _close(got[s, g], nll(np.log(sigma), np.log(lam)), 1e-8)


def test_unported_gp_options_raise(problem):
    x, y, _, _, _ = problem
    with pytest.raises(ValueError, match="probe_vectors"):
        gp.mle_grid(x, y, levels=2, rank=4, sigmas=[1.0], noises=[0.1],
                    logdet="slq", slq_probe_vectors=torch.ones((2, 3)),
                    device="cpu")
    with pytest.raises(ValueError, match="logdet"):
        gp.mle_grid(x, y, levels=2, rank=4, sigmas=[1.0], noises=[0.1],
                    logdet="dense", device="cpu")
    with pytest.raises(ValueError, match="sigma-foldable"):
        gp.mle_objective(x, y, levels=2, rank=4, name="matern", device="cpu")


def test_kernels_refuse_inputs_that_need_a_gradient():
    """The CUDA kernels have no backward pass: on the card an input that
    needs a gradient raises instead of giving a gradient without the
    kernel.  A stand-in carries a CUDA device (the check reads only
    ``.device`` and ``.requires_grad``)."""
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                    requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        _build.cuda_device("build_gram", on_card)
    with torch.no_grad():
        with pytest.raises(TypeError, match="float32 or float64"):
            _build.cuda_device("build_gram", types.SimpleNamespace(
                device=torch.device("cuda", 0), requires_grad=True,
                dtype=torch.int32))


def test_gp_entry_points_run_on_the_card_by_default(monkeypatch, problem):
    x, y, _, _, _ = problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: gp.fit_gp(x, y, kernel=BaseKernel(), noise=0.1,
                                   rank=4, levels=2),
                 lambda: gp.mle_grid(x, y, levels=2, rank=4, sigmas=[1.0],
                                     noises=[0.1]),
                 lambda: gp.mle_objective(x, y, levels=2, rank=4)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
