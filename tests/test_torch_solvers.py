"""Port parity: the matvec-free solvers (repro_torch.solvers) and their two
stages, ``kernel_matvec`` (B10) and ``pairwise_kernel`` (B11).

The same numpy inputs go through the JAX reference in float64 -- its
``xla`` path and its Pallas kernels in interpret mode -- and through the
port's plain PyTorch path on the CPU.  Random draws do not cross
frameworks: the SLQ probes and the EigenPro subsample are drawn from the
reference's keys and injected.  Tolerance 1e-10 relative (to the largest
entry) in float64 unless a line says otherwise; ``pcg`` iteration counts
are equal.  The CUDA kernels run only on the card, where chip_smoke.py
holds them against these plain versions.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import port_build

from repro.core import hck as jhck
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.kernel_tile import ops as jtile_ops
from repro.kernels.kernel_tile.ref import pairwise_kernel_ref as jpairwise_ref
from repro.kernels.matvec_stage import ops as jmatvec_ops
from repro.kernels.matvec_stage.ref import kernel_matvec_ref as jmatvec_ref
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.solvers import cg as jcg
from repro.solvers import eigenpro as jeigenpro
from repro.solvers import operators as jops
from repro.solvers import slq as jslq
from repro_torch import convert
from repro_torch.core import hmatrix
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build, registry
from repro_torch.kernels.kernel_tile import ops as tile_ops
from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref
from repro_torch.kernels.matvec_stage import ops as matvec_ops
from repro_torch.kernels.matvec_stage.ref import kernel_matvec_ref
from repro_torch.solvers import (CGResult, ExactKernelOp, HCKOp,
                                 build_precond, eigenpro_solve, lanczos, pcg,
                                 slq_logdet)
from repro_torch.solvers import cg as cg_mod
from repro_torch.solvers.slq import rademacher_probes

KERNELS = ["gaussian", "imq", "laplace"]
SIGMA, JITTER = 1.7, 1e-7


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# B10 kernel_matvec and B11 pairwise_kernel: plain versions vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KERNELS)
def test_kernel_matvec_matches_reference(f64, name):
    """Odd shapes; the reference's xla oracle and its Pallas kernel (which
    pads to 128-row blocks) against the plain version and the wrapper,
    which on CPU tensors runs the plain version and launches nothing."""
    rng = _rng(1)
    xc, y, v = (rng.standard_normal(s) for s in ((70, 5), (190, 5), (190, 3)))
    opts = dict(name=name, sigma=SIGMA)
    wants = [jmatvec_ref(*map(jnp.asarray, (xc, y, v)), **opts),
             jmatvec_ops.kernel_matvec(*map(jnp.asarray, (xc, y, v)),
                                       interpret=True, **opts)]
    before = matvec_ops.kernel_matvec.launches, kernel_matvec_ref.calls
    for got in (kernel_matvec_ref(_t(xc), _t(y), _t(v), **opts),
                matvec_ops.kernel_matvec(_t(xc), _t(y), _t(v), **opts),
                registry.get_impl("kernel_matvec", "torch")(
                    _t(xc), _t(y), _t(v), **opts)):
        assert got.dtype == torch.float64
        for want in wants:
            _close(got, want)
    assert matvec_ops.kernel_matvec.launches == before[0]
    assert kernel_matvec_ref.calls == before[1] + 3


@pytest.mark.parametrize("name", KERNELS)
def test_pairwise_kernel_matches_reference(f64, name):
    """float32 like the reference (inputs cast): the plain version against
    the reference's jnp oracle and its Pallas kernel at 130 x 140 rows
    (above its 128-row threshold, padded), within 2e-6: both compute in
    float32, summing in other orders, and the values lie in (0, 1]."""
    rng = _rng(2)
    x, y = rng.standard_normal((130, 6)), rng.standard_normal((140, 6))
    opts = dict(name=name, sigma=SIGMA)
    wants = [jpairwise_ref(jnp.asarray(x), jnp.asarray(y), **opts),
             jtile_ops.pairwise_kernel(jnp.asarray(x), jnp.asarray(y),
                                       interpret=True, **opts)]
    before = tile_ops.pairwise_kernel.launches
    for got in (pairwise_kernel_ref(_t(x), _t(y), **opts),
                tile_ops.pairwise_kernel(_t(x), _t(y), **opts),
                registry.get_impl("pairwise_kernel", "torch")(
                    _t(x), _t(y), **opts)):
        assert got.dtype == torch.float32 and got.shape == (130, 140)
        for want in wants:
            assert np.asarray(want).dtype == np.float32
            assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-6
    assert tile_ops.pairwise_kernel.launches == before


def test_kernel_stages_check_their_inputs():
    """Shape checks, the unknown kernel, the backend registry, and the CUDA
    checks the card's launches pass (a stand-in carries a CUDA device)."""
    x = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown base kernel"):
        matvec_ops.kernel_matvec(x, x, x, name="matern")
    with pytest.raises(ValueError, match=r"xc \(b, d\)"):
        matvec_ops.kernel_matvec(x, x, torch.zeros((5, 2)))
    with pytest.raises(ValueError, match=r"x \(n, d\)"):
        tile_ops.pairwise_kernel(x, torch.zeros((4, 2)))
    assert registry.resolve_backend(None, "kernel_matvec", x) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        registry.resolve_backend(registry.SolveConfig(backend="cuda"),
                                 "pairwise_kernel", x)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0),
                                    requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward pass"):
        _build.cuda_device("kernel_matvec", on_card)
    assert {"kernel_matvec", "kernel_tile"} <= set(_build.KERNELS)
    assert "pair_tile.cuh" in _build._HEADERS
    # one launch keeps up to max_columns columns within the shared memory
    for itemsize in (4, 8):
        k = matvec_ops.max_columns(itemsize)
        assert matvec_ops.matvec_smem(k, itemsize) <= _build.SMEM_MAX
        assert matvec_ops.matvec_smem(k + 1, itemsize) > _build.SMEM_MAX
        assert k >= 160


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def points(f64):
    """(x (333, 4), queries (41, 4), rhs (333, 2))."""
    rng = _rng(3)
    return (rng.standard_normal((333, 4)), rng.standard_normal((41, 4)),
            rng.standard_normal((333, 2)))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_exact_operator_matches_reference_and_dense(points, backend):
    """matvec (with and without the jitter diagonal, 1-D and 2-D) and
    cross_matvec, row chunks of 100 over 333 rows (a ragged last chunk)."""
    x, q, v = points
    jop = jops.ExactKernelOp(jnp.asarray(x), JKernel("gaussian", 2.0, JITTER),
                             JSolveConfig(backend=backend, interpret=True),
                             row_chunk=100)
    ker = BaseKernel("gaussian", 2.0, JITTER)
    op = ExactKernelOp(_t(x), ker, row_chunk=100)
    assert op.shape == (333, 333) and op.dtype == torch.float64
    _close(op.matvec(_t(v)), jop.matvec(jnp.asarray(v)))
    _close(op(_t(v[:, 0])), jop.matvec(jnp.asarray(v[:, 0])))
    _close(op.matvec(_t(v)), ker.gram(_t(x)) @ _t(v))
    _close(op.cross_matvec(_t(q), _t(v)),
           jop.cross_matvec(jnp.asarray(q), jnp.asarray(v)))
    _close(op.cross_matvec(_t(q), _t(v[:, 1])), ker.cross(_t(q), _t(x))
           @ _t(v[:, 1]))
    bare = ExactKernelOp(_t(x), ker, row_chunk=1000, include_jitter=False)
    _close(bare.matvec(_t(v)), ker.cross(_t(x), _t(x)) @ _t(v))


def test_operators_shard_only_with_the_distributed_port(points):
    x, _, _ = points
    op = ExactKernelOp(_t(x), BaseKernel())
    with pytest.raises(NotImplementedError, match="A14"):
        op.sharded(None)
    with pytest.raises(NotImplementedError, match="A14"):
        cg_mod.axis_dot("dev")


@pytest.fixture(scope="module")
def hck_factors(f64):
    """(reference factors, port factors) at n 512, d 3, rank 8, leaf 16."""
    x = _rng(4).standard_normal((512, 3))
    key = jax.random.PRNGKey(4)
    jker, ker = JKernel("gaussian", 1.5, 1e-8), BaseKernel("gaussian", 1.5,
                                                          1e-8)
    jf = jhck.build_hck(jnp.asarray(x), levels=5, rank=8, key=key,
                        kernel=jker)
    return jf, port_build(jf, x, key, ker, 8)


def test_hck_operator_matches_matvec(hck_factors):
    jf, f = hck_factors
    b = _rng(5).standard_normal((512, 3))
    op = HCKOp(f)
    assert op.shape == (512, 512) and op.dtype == torch.float64
    _close(op.matvec(_t(b)), hmatrix.matvec(f, _t(b)))
    _close(op(_t(b)), jops.HCKOp(jf).matvec(jnp.asarray(b)))


# ---------------------------------------------------------------------------
# pcg
# ---------------------------------------------------------------------------

def _spd(n, seed, shift):
    a = _rng(seed).standard_normal((n, n))
    return a @ a.T / n + shift * np.eye(n)


def _same_result(res, jres, rtol=1e-10):
    assert isinstance(res, CGResult)
    assert res.iterations == int(jres.iterations)
    assert res.converged == bool(jres.converged)
    _close(res.x, jres.x, rtol)
    _close(res.residuals, jres.residuals, rtol)


@pytest.mark.parametrize("flexible", [True, False], ids=["pr", "fr"])
@pytest.mark.parametrize("rhs", ["single", "multi"])
def test_pcg_matches_reference(f64, rhs, flexible):
    """Plain and Jacobi-preconditioned CG with a ridge; iterations equal,
    the trace (entry 0 the initial residual, frozen past the exit) and x
    within 1e-10.  The operator's condition number is ~15: on a spectrum
    that reaches down to the ridge, CG's round-off sensitivity makes two
    BLAS' summation orders differ by 1e-8 in the late trace."""
    n = 60
    a = _spd(n, 6, 0.3)
    b = _rng(7).standard_normal((n,) if rhs == "single" else (n, 3))
    dinv = 1.0 / (np.diag(a) + 0.1)
    for precond in (None, "jacobi"):
        kw = dict(ridge=0.1, tol=1e-9, maxiter=200, flexible=flexible)
        jres = jcg.pcg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                       precond=None if precond is None else (
                           lambda r: jnp.asarray(dinv).reshape(
                               (n,) + (1,) * (r.ndim - 1)) * r), **kw)
        res = pcg(lambda v: _t(a) @ v, _t(b),
                  precond=None if precond is None else (
                      lambda r: _t(dinv).reshape((n,) + (1,) * (r.ndim - 1))
                      * r), **kw)
        _same_result(res, jres)
        assert res.converged and 0 < res.iterations < 200
        assert res.x.shape == b.shape and res.residuals.shape == (201,)
        assert float(res.residuals[0]) == pytest.approx(1.0)
        tail = res.residuals[res.iterations:]
        assert torch.equal(tail, tail[:1].expand_as(tail))


def test_pcg_fixed_iterations_and_warm_start(f64):
    """tol = 0 runs exactly maxiter iterations and reports no convergence;
    a warm start from the answer exits at once."""
    a = _spd(50, 8, 1.0)
    b = np.ones((50,))
    kw = dict(tol=0.0, maxiter=7)
    res = pcg(lambda v: _t(a) @ v, _t(b), **kw)
    _same_result(res, jcg.pcg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                              **kw))
    assert res.iterations == 7 and not res.converged
    x0 = np.linalg.solve(a, b)
    warm = pcg(lambda v: _t(a) @ v, _t(b), x0=_t(x0), tol=1e-8)
    assert warm.iterations == 0 and warm.converged


def test_pcg_breakdown_freeze_on_a_singular_operator(f64):
    """A singular diagonal operator (exact zeros, so every summation order
    gives the same bits) with an inconsistent right-hand side beside a
    consistent one: once the inconsistent column's direction lies in the
    null space (p^T A p = 0) it is frozen and stays finite, bit for bit
    the reference's path; the consistent column reaches its solution."""
    d = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.0, 0.0, 0.0, 0.0])
    a = np.diag(d)
    b = np.stack([np.ones(10), d * _rng(11).standard_normal(10)], axis=1)
    kw = dict(tol=1e-10, maxiter=40)
    res = pcg(lambda v: _t(a) @ v, _t(b), **kw)
    jres = jcg.pcg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), **kw)
    _same_result(res, jres)
    assert res.iterations == 40 and not res.converged
    assert bool(torch.isfinite(res.x).all())
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    _close(res.x[:, 1], inv * b[:, 1], 1e-10)


# ---------------------------------------------------------------------------
# Lanczos and SLQ
# ---------------------------------------------------------------------------

def test_lanczos_matches_reference(f64):
    """alpha and beta of 12 steps with full reorthogonalisation, and the
    whole spectrum at iters = n; a local all_reduce hook changes nothing."""
    n = 24
    a = _spd(n, 12, 1.0)
    v0 = _rng(13).standard_normal(n)
    ja, jb = jslq.lanczos(lambda v: jnp.asarray(a) @ v, jnp.asarray(v0), 12)
    al, be = lanczos(lambda v: _t(a) @ v, _t(v0), 12)
    _close(al, ja)
    _close(be, jb)
    al2, be2 = lanczos(lambda v: _t(a) @ v, _t(v0), 12,
                       all_reduce=lambda s: s)
    assert torch.equal(al, al2) and torch.equal(be, be2)
    al, be = lanczos(lambda v: _t(a) @ v, _t(v0), n)
    t = torch.diag(al) + torch.diag(be, 1) + torch.diag(be, -1)
    _close(torch.linalg.eigvalsh(t), np.linalg.eigvalsh(a), 1e-10)


def test_slq_logdet_matches_reference_and_exact(hck_factors):
    """SLQ through the HCK matvec over a ridge grid, with the reference's
    Rademacher probes injected: equal to the reference's to 1e-10.  Then
    against the Algorithm-2 ``logabsdet``: SLQ equals the Hutchinson mean
    z^T log(A) z of the same probes up to the Gauss-quadrature error
    (1e-6 relative at 64 steps), and that mean is within 4 standard
    deviations of its expectation, sqrt(2 sum_{i != j} log(A)_ij^2 /
    probes), of the log-determinant.  The reference's own test of this
    (its 0.025 nats-per-point gate, ROADMAP C2) is not evidence."""
    jf, f = hck_factors
    ridges = [1e-2, 1e-1, 1.0]
    key = jax.random.PRNGKey(7)
    probes = 16
    z = jax.random.rademacher(key, (probes, f.n), dtype=jnp.float64)
    want = jslq.slq_logdet(jops.HCKOp(jf).matvec, f.n, ridges=jnp.asarray(
        ridges), probes=probes, iters=64, key=key, dtype=jnp.float64)
    got = slq_logdet(HCKOp(f).matvec, f.n, ridges=ridges, iters=64,
                     probe_vectors=_t(z))
    _close(got, want)
    one = slq_logdet(HCKOp(f).matvec, f.n, iters=64, probe_vectors=_t(z))
    _close(one, jslq.slq_logdet(jops.HCKOp(jf).matvec, f.n, probes=probes,
                                iters=64, key=key, dtype=jnp.float64))
    dense = hck_factors[1]
    from repro_torch.core.hck import to_dense

    a = to_dense(dense)
    zt = _t(z)
    for g, ridge in enumerate(ridges):
        w, vecs = torch.linalg.eigh(a + ridge * torch.eye(f.n,
                                                         dtype=a.dtype))
        log_a = vecs @ torch.diag(torch.log(w)) @ vecs.T
        hutch = float(torch.mean(torch.einsum("pi,ij,pj->p", zt, log_a, zt)))
        exact = float(hmatrix.invert(f, ridge).logabsdet)
        assert abs(float(got[g]) - hutch) <= 1e-6 * abs(hutch)
        off = log_a - torch.diag(torch.diagonal(log_a))
        std = float(torch.sqrt(2 * torch.sum(off ** 2) / probes))
        assert abs(float(got[g]) - exact) <= 4 * std, (g, got[g], exact, std)


def test_rademacher_probes_from_a_generator():
    z = rademacher_probes(5, 300, dtype=torch.float64, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    assert z.shape == (5, 300) and z.dtype == torch.float64
    assert set(torch.unique(z).tolist()) == {-1.0, 1.0}
    again = rademacher_probes(5, 300, dtype=torch.float64, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(z, again)


# ---------------------------------------------------------------------------
# EigenPro
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eigenpro_problem(f64):
    """(x (400, 4), y (400, 1), the reference's subsample permutation)."""
    rng = _rng(14)
    x = rng.standard_normal((400, 4))
    return x, np.sin(x[:, :1]), jax.random.permutation(
        jax.random.PRNGKey(2), 400)


def test_build_precond_matches_reference(eigenpro_problem):
    """Subsample 300, 60 components: the eigenvectors up to sign, the
    weights, the tail and rho."""
    x, _, perm = eigenpro_problem
    jker, ker = JKernel("gaussian", 2.0, 1e-6), BaseKernel("gaussian", 2.0,
                                                          1e-6)
    kw = dict(n_components=60, subsample=300)
    want = jeigenpro.build_precond(
        jops.ExactKernelOp(jnp.asarray(x), jker, row_chunk=128),
        jax.random.PRNGKey(2), **kw)
    got = build_precond(ExactKernelOp(_t(x), ker, row_chunk=128),
                        permutation=_t(perm), **kw)
    for field in ("weights", "tail", "rho"):
        _close(getattr(got, field), getattr(want, field), 1e-8)
    kept = int(torch.count_nonzero(got.weights))
    signs = torch.sign(torch.sum(got.u * _t(want.u), dim=0))
    _close((got.u * signs)[:, :kept], np.asarray(want.u)[:, :kept], 1e-6)
    g = _rng(15).standard_normal((400, 2))
    _close(got.apply(_t(g)), want.apply(jnp.asarray(g)), 1e-8)
    # the reference's preconditioner carried across applies the same
    carried = convert.eigenpro_from_arrays(
        {"vecs": np.asarray(want.u), "weights": np.asarray(want.weights),
         "tail": np.asarray(want.tail), "rho": np.asarray(want.rho)},
        device="cpu")
    _close(carried.apply(_t(g)), want.apply(jnp.asarray(g)))


def test_eigenpro_solve_matches_reference(eigenpro_problem):
    """The Richardson loop on the reference's own preconditioner (carried
    across): x, iterations and the trace; and the port's own build with
    the injected permutation converges to the dense solution."""
    x, y, perm = eigenpro_problem
    jker, ker = JKernel("gaussian", 2.0, 1e-6), BaseKernel("gaussian", 2.0,
                                                          1e-6)
    jop = jops.ExactKernelOp(jnp.asarray(x), jker, row_chunk=128)
    kw = dict(ridge=5e-2, tol=1e-8, maxiter=300)
    jpc = jeigenpro.build_precond(jop, jax.random.PRNGKey(2),
                                  n_components=60, subsample=300)
    jres = jeigenpro.eigenpro_solve(jop, jnp.asarray(y), precond=jpc, **kw)
    pc = convert.eigenpro_from_arrays(
        {"vecs": np.asarray(jpc.u), "weights": np.asarray(jpc.weights),
         "tail": np.asarray(jpc.tail), "rho": np.asarray(jpc.rho)},
        device="cpu")
    op = ExactKernelOp(_t(x), ker, row_chunk=128)
    res = eigenpro_solve(op, _t(y), precond=pc, **kw)
    _same_result(res, jres, 1e-8)
    assert res.converged
    own = eigenpro_solve(op, _t(y[:, 0]), permutation=_t(perm),
                         n_components=60, subsample=300, **kw)
    dense = torch.linalg.solve(ker.gram(_t(x)) + 5e-2 * torch.eye(400),
                               _t(y[:, 0]))
    assert own.converged and own.x.shape == (400,)
    assert float((own.x - dense).abs().max()) < 1e-5
