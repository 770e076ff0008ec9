"""Port parity of the HCK preconditioner of exact-kernel KRR, and what it
does to CG on two data sets (ROADMAP item C6).

At n = 4,096 in float64 on the CPU, both packages fit the same numpy data
with ``krr.fit_exact``, with and without the preconditioner, the port with
the reference's preconditioner draws injected:

* "covtype": ``chip_smoke.make_data``'s distribution (d 54, x ~ N(0,
  2/d I), seven labels one-vs-all), gaussian sigma 1, jitter 1e-5,
  lambda 1e-2, rank 128;
* "bench_cg": ``benchmarks/bench_cg.py``'s shape (d 4, x ~ N(0, I), a
  smooth regression target), gaussian sigma 2, jitter 1e-6, lambda 1e-2,
  rank 128.

The test holds the port's CG iteration counts to tol 1e-2 within one of
the reference's (two summation orders in float64 can move a stop that
lands at the tolerance by one iteration), and the dense preconditioner P
of the port, its columns P e_j, to the reference's at 1e-8 relative.
Plain CG on bench_cg's operator (condition ~1e5) magnifies the two
summation orders further (79 against 84 iterations were read), so that
count is printed for both packages and not held. The test prints the
counts and the extreme eigenvalues of K + lambda I and of
P (K + lambda I) (``pytest -s``): those readings are ROADMAP C6's witness
that the preconditioner's effect on CG at d = 54 belongs to the algorithm
on this data, not to the card or to float32.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_exact import precond_draws

from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch.core import krr
from repro_torch.core.kernels_fn import BaseKernel

N, RANK, LAM, TOL, MAXITER = 4096, 128, 1e-2, 1e-2, 500
# name: (d, sigma, jitter, classification, plain CG count held)
CASES = {"covtype": (54, 1.0, 1e-5, True, True),
         "bench_cg": (4, 2.0, 1e-6, False, False)}


def _data(case):
    d, _, _, classification, _ = CASES[case]
    rng = np.random.default_rng(0)
    if classification:
        g = rng.standard_normal((d, 7))
        x = math.sqrt(2.0 / d) * rng.standard_normal((N, d))
        t = x @ g
        return x, np.argmax(np.sin(3.0 * t) + 0.5 * t * t, axis=1)
    x = rng.standard_normal((N, d))
    return x, np.sin(x[:, 0]) + 0.25 * np.cos(2.0 * x[:, 1])


def _extremes(mat):
    w = torch.linalg.eigvalsh(mat)
    return float(w[0]), float(w[-2]), float(w[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_preconditioner_matches_reference_and_its_spectrum(f64, case):
    _, sigma, jitter, classification, plain_held = CASES[case]
    x, y = _data(case)
    key = jax.random.PRNGKey(3)
    draws = precond_draws(key, x, RANK)
    ker = BaseKernel("gaussian", sigma, jitter)
    cfg = JSolveConfig(backend="xla")
    its = {}
    for pre in (True, False):
        opts = dict(lam=LAM, rank=RANK, tol=TOL, maxiter=MAXITER,
                    classification=classification, precondition=pre)
        ref = jkrr.fit_exact(jnp.asarray(x), jnp.asarray(y),
                             kernel=JKernel("gaussian", sigma, jitter),
                             key=key, solve_config=cfg, **opts)
        port = krr.fit_exact(x, y, kernel=ker, device="cpu", **opts,
                             **(draws if pre else {}))
        assert bool(ref.result.converged) and port.result.converged
        its[pre] = (int(ref.result.iterations), port.result.iterations)
        if pre or plain_held:
            assert abs(its[pre][0] - its[pre][1]) <= 1, its

    xt = torch.from_numpy(x)
    eye = np.eye(N)
    prec, _, _ = krr._hck_preconditioner(
        xt, kernel=ker, lam=LAM, rank=RANK, leaf_size=None, levels=None,
        method="rp", solve_config=None, generator=torch.Generator(), **draws)
    p_port = prec(torch.from_numpy(eye))
    jprec, _, _ = jkrr._hck_preconditioner(
        jnp.asarray(x), kernel=JKernel("gaussian", sigma, jitter), lam=LAM,
        rank=RANK, leaf_size=None, levels=None, key=key, method="rp",
        solve_config=cfg)
    p_ref = np.asarray(jprec(jnp.asarray(eye)))
    gap = float(np.abs(p_port.numpy() - p_ref).max() / np.abs(p_ref).max())
    assert gap <= 1e-8, gap

    a = ker.gram(xt) + LAM * torch.eye(N, dtype=torch.float64)
    chol = torch.linalg.cholesky(0.5 * (p_port + p_port.T))
    lo_a, second_a, hi_a = _extremes(a)
    lo_p, _, hi_p = _extremes(chol.T @ a @ chol)
    print(f"\n[C6 witness] {case}: n {N}, d {x.shape[1]}, gaussian sigma "
          f"{sigma}, jitter {jitter}, lambda {LAM}, rank {RANK}, float64; "
          f"CG iterations to tol {TOL:g} (reference, port): preconditioned "
          f"{its[True]}, plain {its[False]}; K + lam I: min {lo_a:.4g}, "
          f"second largest {second_a:.4g}, max {hi_a:.4g}, cond "
          f"{hi_a / lo_a:.4g}, cond without the top "
          f"eigenvalue {second_a / lo_a:.4g}; P (K + lam I): min {lo_p:.4g}, "
          f"max {hi_p:.4g}, cond {hi_p / lo_p:.4g}; max |P_port - P_ref| / "
          f"max |P_ref| {gap:.2e}")
