"""Port parity: structured algebra on the HCK matrix (repro_torch.core.hmatrix).

The JAX reference builds the factors (float64); ``repro_torch.convert``
carries them across, so both sides run the same algebra on the same
factors.  Matvec, the Algorithm-2 inverse, its apply, the refined solve
and logdet go through the reference under its ``xla`` backend and its
Pallas kernels in interpret mode, and through the port's plain PyTorch
path on the CPU.  Tolerance 1e-10 relative unless a line says otherwise.
The dense oracle ``to_dense`` holds both at 1e-6, the reference's own gate
(tests/test_solve_engine.py): U = K(X, Z) Sigma^-1 is amplified by
kappa(Sigma), and the two representations of one matrix round apart by
~2e-8 relative on a solution here, in the reference as in the port.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_oos import flatten_model

from repro.core import hck as jhck
from repro.core import hmatrix as jhm
from repro.core import oos as joos
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch import convert
from repro_torch.core import hck, hmatrix
from repro_torch.kernels import registry
from repro_torch.kernels.hck_leaf import ops as leaf_ops
from repro_torch.kernels.hck_leaf.ref import (hck_leaf_factor_ref,
                                              hck_leaf_matvec_ref,
                                              hck_leaf_solve_ref)

N, D, RANK, LEAF, LEVELS = 512, 3, 8, 16, 5
SIGMA, JITTER, LAM = 1.5, 1e-8, 1e-2
BACKENDS = ["xla", "pallas"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def _jcfg(backend):
    return JSolveConfig(backend=backend, interpret=True)


@pytest.fixture(scope="module")
def factors(f64):
    """(reference factors, the same factors in the port, rhs (n, 3))."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D))
    jf = jhck.build_hck(jnp.asarray(x), levels=LEVELS, rank=RANK,
                        key=jax.random.PRNGKey(1),
                        kernel=JKernel("gaussian", SIGMA, JITTER))
    arrays = flatten_model(jf, joos.prepare(jf, jnp.zeros((N, 1))))
    f = convert.factors_from_arrays(arrays, device="cpu")
    return jf, f, rng.standard_normal((N, 3))


# ---------------------------------------------------------------------------
# Leaf stages B3, B4, B5: plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

def test_leaf_stage_refs_match_pallas(f64):
    from repro.kernels.hck_leaf import ops as jleaf

    rng = np.random.default_rng(1)
    p, k = 8, 3
    a = rng.standard_normal((p, LEAF, LEAF))
    spd = a @ a.transpose(0, 2, 1) + LEAF * np.eye(LEAF)
    u = rng.standard_normal((p, LEAF, RANK))
    b = rng.standard_normal((p, LEAF, k))
    sig = rng.standard_normal((p, RANK, RANK))
    want_lo, want_li = jleaf.leaf_factor(jnp.asarray(spd), interpret=True)
    want_mv = jleaf.leaf_matvec(jnp.asarray(spd), jnp.asarray(u),
                                jnp.asarray(b), interpret=True)
    want_sv = jleaf.leaf_solve(want_li, jnp.asarray(u), jnp.asarray(sig),
                               jnp.asarray(b), interpret=True)
    counts = (leaf_ops.leaf_factor.launches, leaf_ops.leaf_matvec.launches,
              leaf_ops.leaf_solve.launches)
    for fac, mv, sv in ((hck_leaf_factor_ref, hck_leaf_matvec_ref,
                         hck_leaf_solve_ref),
                        (leaf_ops.leaf_factor, leaf_ops.leaf_matvec,
                         leaf_ops.leaf_solve)):
        lo, li = fac(_t(spd))
        _close(lo, want_lo)
        _close(li, want_li)
        for got, want in zip(mv(_t(spd), _t(u), _t(b)), want_mv):
            _close(got, want)
        for got, want in zip(sv(_t(want_li), _t(u), _t(sig), _t(b)), want_sv):
            _close(got, want)
        # one Sig per sibling pair, read by both leaves
        got = sv(_t(want_li), _t(u), _t(sig[::2]), _t(b))
        want = hck_leaf_solve_ref(_t(want_li), _t(u), _t(np.repeat(
            sig[::2], 2, axis=0)), _t(b))
        for g, w in zip(got, want):
            _close(g, w, 0)
    # on CPU tensors the wrappers run the plain versions and launch nothing
    assert counts == (leaf_ops.leaf_factor.launches,
                      leaf_ops.leaf_matvec.launches,
                      leaf_ops.leaf_solve.launches)


def test_leaf_wrappers_reject_bad_shapes():
    z = torch.zeros
    with pytest.raises(ValueError, match="leaf_factor"):
        leaf_ops.leaf_factor(z(4, 16, 8))
    with pytest.raises(ValueError, match="leaf_matvec"):
        leaf_ops.leaf_matvec(z(4, 16, 16), z(4, 15, 8), z(4, 16, 2))
    with pytest.raises(ValueError, match="leaf_solve"):
        leaf_ops.leaf_solve(z(4, 16, 16), z(4, 16, 8), z(3, 8, 8),
                            z(4, 16, 2))
    assert leaf_ops.factor_smem(128, 8) <= 227 * 1024
    # B4 stages Linv's triangle and U at the fit's shape, two blocks an SM
    assert 2 * (leaf_ops.solve_smem(128, 128, 7, 4) + 1024) <= 228 * 1024


# ---------------------------------------------------------------------------
# Algorithm 1 and Algorithm 2 against the reference and the dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cols", [None, 3], ids=["vector", "block"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_matvec_matches_reference(factors, backend, cols):
    jf, f, b = factors
    b = b[:, 0] if cols is None else b
    want = jhm.matvec(jf, jnp.asarray(b), _jcfg(backend))
    got = hmatrix.matvec(f, _t(b))
    _close(got, want)
    _close(got, hmatrix.matvec_dense_reference(f, _t(b)), 1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_invert_with_leaf_matches_reference(factors, backend):
    jf, f, _ = factors
    jinv, jlo = jhm.invert_with_leaf(jf, LAM, _jcfg(backend))
    inv, lo = hmatrix.invert_with_leaf(f, LAM)
    _close(lo, jlo)
    for field in ("adiag", "u", "linv", "logabsdet"):
        _close(getattr(inv, field), getattr(jinv, field))
    for field in ("sigma", "w"):
        for got, want in zip(getattr(inv, field), getattr(jinv, field)):
            _close(got, want)
    plain = hmatrix.invert(f, LAM)
    _close(plain.adiag, inv.adiag, 0)
    # the explicit inverse blocks equal (linv^T linv + U Sig U^T) per leaf
    dense_inv = torch.linalg.inv(hck.to_dense(f) + LAM * torch.eye(N))
    x = _t(np.random.default_rng(2).standard_normal((N, 2)))
    _close(hmatrix.apply_inverse(inv, x), dense_inv @ x, 1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_and_logdet_match_reference(factors, backend):
    jf, f, b = factors
    cfg = _jcfg(backend)
    jinv = jhm.invert(jf, LAM, cfg)
    inv = hmatrix.invert(f, LAM)
    _close(hmatrix.apply_inverse(inv, _t(b)),
           jhm.apply_inverse(jinv, jnp.asarray(b), cfg))
    got = hmatrix.solve_with_inverse(f, inv, _t(b), LAM)
    _close(got, jhm.solve_with_inverse(jf, jinv, jnp.asarray(b), LAM, cfg))
    _close(hmatrix.solve(f, _t(b[:, 1]), LAM),
           jhm.solve(jf, jnp.asarray(b[:, 1]), LAM, cfg))
    dense = hck.to_dense(f) + LAM * torch.eye(N)
    _close(got, torch.linalg.solve(dense, _t(b)), 1e-6)
    # against its own matvec the refined solve is exact to round-off
    resid = _t(b) - hmatrix.matvec(f, got) - LAM * got
    assert torch.linalg.vector_norm(resid) <= 1e-12 * np.linalg.norm(b)
    ld = hmatrix.logdet(f, LAM)
    _close(ld, jhm.logdet(jf, LAM, cfg))
    _close(ld, torch.linalg.slogdet(dense)[1], 1e-6)


def test_apply_inverse_leaf_paths_agree(factors):
    """The fused leaf_solve form (apply_inverse's path on both backends) and
    the explicit-inverse leaf_matvec form (the reference's xla path) give
    one operator; apply_inverse runs the fused form's plain version."""
    _, f, b = factors
    inv = hmatrix.invert(f, LAM)
    bb = _t(b).reshape(f.num_leaves, LEAF, 3)
    x, c = hck_leaf_solve_ref(inv.linv, inv.u, inv.sigma[-1], bb)
    fused = x + hmatrix._offdiag_apply(inv.sigma, inv.w, inv.u, c, LEVELS)
    y, c = hck_leaf_matvec_ref(inv.adiag, inv.u, bb)
    explicit = y + hmatrix._offdiag_apply(inv.sigma, inv.w, inv.u, c, LEVELS)
    _close(fused, explicit, 1e-10)
    before = hck_leaf_solve_ref.calls, hck_leaf_matvec_ref.calls
    got = hmatrix.apply_inverse(inv, _t(b))
    assert (hck_leaf_solve_ref.calls, hck_leaf_matvec_ref.calls) == (
        before[0] + 1, before[1])
    assert torch.equal(got, fused.reshape(N, 3))


def test_refinement_never_accepts_a_growing_residual(factors):
    """A wrong inverse (the negated one) makes every refinement step grow
    the residual; the monotone safeguard keeps the first answer."""
    _, f, b = factors
    b = _t(b)
    inv = hmatrix.invert(f, LAM)
    bad = dataclasses.replace(inv, adiag=-inv.adiag,
                              sigma=tuple(-s for s in inv.sigma))

    def resid(x):
        return torch.linalg.vector_norm(b - hmatrix.matvec(f, x) - LAM * x)

    x0 = hmatrix.apply_inverse(bad, b)
    step = x0 + hmatrix.apply_inverse(bad, b - hmatrix.matvec(f, x0) - LAM * x0)
    assert resid(step) > resid(x0)            # the unguarded step grows it
    got = hmatrix.solve_with_inverse(f, bad, b, LAM)
    assert torch.equal(got, x0)
    # with the right inverse every step is taken and the residual shrinks
    cfg0 = registry.SolveConfig(refine_steps=0)
    assert resid(hmatrix.solve_with_inverse(f, inv, b, LAM)) <= resid(
        hmatrix.solve_with_inverse(f, inv, b, LAM, cfg0))


def test_levels0_invert_and_solve_match_reference(f64):
    x = np.random.default_rng(3).standard_normal((32, D))
    b = np.random.default_rng(4).standard_normal(32)
    jf = jhck.build_hck(jnp.asarray(x), levels=0, rank=4,
                        key=jax.random.PRNGKey(1),
                        kernel=JKernel("imq", SIGMA, JITTER))
    f = convert.factors_from_arrays(
        flatten_model(jf, joos.prepare(jf, jnp.zeros((32, 1)))), device="cpu")
    _close(hmatrix.matvec(f, _t(b)), jhm.matvec(jf, jnp.asarray(b)))
    _close(hmatrix.solve(f, _t(b), LAM), jhm.solve(jf, jnp.asarray(b), LAM))
    _close(hmatrix.logdet(f, LAM), jhm.logdet(jf, LAM))
    with pytest.raises(ValueError, match="levels >= 1"):
        hmatrix.invert_with_leaf(f, LAM)


def test_forced_cuda_backend_on_cpu_factors_raises(factors):
    _, f, b = factors
    cfg = registry.SolveConfig(backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hmatrix.matvec(f, _t(b), cfg)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hmatrix.invert_with_leaf(f, LAM, cfg)
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="CPU tensors only"):
        registry.resolve_backend(registry.SolveConfig(backend="torch"),
                                 "leaf_solve", on_card)
    with pytest.raises(ValueError, match="refine_steps"):
        registry.SolveConfig(refine_steps=-1)
