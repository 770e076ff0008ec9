"""Port parity: online updates (repro_torch.core.update,
hmatrix.invert_extend, krr.fit_incremental) and their stage
``leaf_update`` (B13).

The JAX reference fits and updates in float64 under its ``xla`` backend;
the port does the same on the CPU with the reference's draws injected: the
fit's directions and landmark rows, and each insert's padding rows and
noise, rebuilt from the insert's key.  Factors agree to 1e-10 relative,
predictions to 1e-8; ``downdate(insert(f))`` and the old quadrants of the
bordered extension are bit for bit.  The CUDA kernel B13 runs only on the
card, where chip_smoke.py holds it against this plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws

from repro.core import hmatrix as jhmatrix
from repro.core import krr as jkrr
from repro.core import update as jupdate
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.kernels.update_stage import ops as jupdate_ops
from repro.kernels.update_stage.ref import leaf_update_ref as jleaf_update_ref
from repro_torch.core import hmatrix, krr, update
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build, registry
from repro_torch.kernels.update_stage import ops as update_ops
from repro_torch.kernels.update_stage.ref import leaf_update_ref

D, SIGMA, JITTER, LAM = 5, 2.0, 1e-8, 1e-2
XLA = JSolveConfig(backend="xla")
# the plain model (n 256, leaves of 32, rank 16) and the budgeted one (n
# 512, leaves of 64, rank 32: at rank 8 the budget's extras snap to 0)
SHAPES = {"plain": (256, 32, 16, None), "budget": (512, 64, 32, 112)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def _target(x):
    return np.sin(x[:, 0]) + 0.25 * np.cos(2.0 * x[:, 1])


def insert_draws(key, p_leaves, k, n0, d=D):
    """The padding rows and noise the reference's insert draws from
    ``key``: ``kidx, knoise = split(key)``."""
    kidx, knoise = jax.random.split(key)
    return dict(
        pad_index=_t(jax.random.randint(kidx, (p_leaves, k), 0, n0)),
        pad_noise=_t(1e-4 * jax.random.normal(knoise, (p_leaves, k, d),
                                              dtype=jnp.float64)))


def _arrivals(seed, q, scale=1.0):
    x = scale * np.random.default_rng(seed).standard_normal((q, D))
    return x, _target(x)


@pytest.fixture(scope="module")
def models(f64):
    """Per shape: (reference model, port model on its draws, queries)."""
    out = {}
    for tag, (n, leaf, rank, bud) in SHAPES.items():
        rng = np.random.default_rng(7 + n)
        x = rng.standard_normal((n, D))
        key = jax.random.PRNGKey(1)
        jm = jkrr.fit(jnp.asarray(x), jnp.asarray(_target(x)),
                      kernel=JKernel("gaussian", SIGMA, JITTER), lam=LAM,
                      rank=rank, leaf_size=leaf, levels=3, key=key,
                      solve_config=XLA, rank_budget=bud)
        _, kbuild = jax.random.split(key)
        m = krr.fit(x, _target(x), kernel=BaseKernel("gaussian", SIGMA,
                                                     JITTER),
                    lam=LAM, rank=rank, leaf_size=leaf, levels=3,
                    device="cpu", rank_budget=bud,
                    directions=[_t(v) for v in jm.factors.tree.directions],
                    landmark_index=landmark_draws(kbuild, n, 3, rank))
        _close(m.predict(_t(x[:8])), jm.predict(jnp.asarray(x[:8])), 1e-8)
        out[tag] = (jm, m, rng.standard_normal((48, D)))
    return out


def _fields_close(f, jf, rtol=1e-10):
    np.testing.assert_array_equal(f.tree.perm.numpy(), np.asarray(jf.tree.perm))
    for field in ("x_sorted", "u", "adiag"):
        _close(getattr(f, field), getattr(jf, field), rtol)


# ---------------------------------------------------------------------------
# B13 leaf_update: plain version vs the reference
# ---------------------------------------------------------------------------

def _bordered(rng, p, n0, k):
    a = rng.standard_normal((p, n0 + k, n0 + k))
    full = a @ a.transpose(0, 2, 1) / (n0 + k) + np.eye(n0 + k)
    lo = np.linalg.cholesky(full[:, :n0, :n0])
    return (lo, np.linalg.inv(lo), full[:, n0:, :n0], full[:, n0:, n0:],
            full)


@pytest.mark.parametrize("k", [1, 5])
def test_leaf_update_matches_reference(f64, k):
    rng = np.random.default_rng(k)
    lo, linv, b, c, full = _bordered(rng, 3, 12, k)
    args = tuple(map(_t, (lo, linv, b, c)))
    jargs = tuple(map(jnp.asarray, (lo, linv, b, c)))
    wants = [jleaf_update_ref(*jargs),
             jupdate_ops.leaf_update(*jargs, interpret=True)]
    before = update_ops.leaf_update.launches
    for got in (leaf_update_ref(*args), update_ops.leaf_update(*args),
                registry.get_impl("leaf_update", "torch")(*args)):
        assert torch.equal(got[0][:, :12, :12], args[0])
        assert torch.equal(got[1][:, :12, :12], args[1])
        assert not got[0][:, :12, 12:].any() and not got[1][:, :12, 12:].any()
        for want in wants:
            _close(got[0], want[0])
            _close(got[1], want[1])
        # the extension factors the bordered matrix, and inverts its factor
        _close(got[0] @ got[0].mT, full)
        _close(got[1] @ got[0], np.broadcast_to(np.eye(12 + k), full.shape))
    assert update_ops.leaf_update.launches == before


def test_leaf_update_non_spd_gives_nan(f64):
    lo, linv, b, c, _ = _bordered(np.random.default_rng(3), 2, 8, 3)
    c[1] -= 50.0 * np.eye(3)                     # leaf 1: S indefinite
    lo_ext, linv_ext = leaf_update_ref(*map(_t, (lo, linv, b, c)))
    want = jleaf_update_ref(*map(jnp.asarray, (lo, linv, b, c)))
    assert torch.isnan(lo_ext[1, 8:, 8:]).any()
    assert torch.isfinite(lo_ext[0]).all() and torch.isfinite(linv_ext[0]).all()
    assert np.isnan(np.asarray(want[0])[1, 8:, 8:]).any()


def test_leaf_update_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="leaf_update"):
        update_ops.leaf_update(torch.zeros(2, 4, 4), torch.zeros(2, 4, 4),
                               torch.zeros(2, 3, 5), torch.zeros(2, 3, 3))
    # covtype leaves grown to 192 + 16 rows fit one block, in f32 and f64
    assert update_ops.update_plan(192, 16, 8)["smem"] <= _build.SMEM_MAX
    assert update_ops.update_plan(192, 400, 4)["smem"] > _build.SMEM_MAX
    for backend in ("torch", "cuda"):
        assert registry.get_impl("leaf_update", backend) is not None


# ---------------------------------------------------------------------------
# insert, downdate, refit_frozen, invert_extend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inserted(models):
    """The reference's and the port's insert of 23 points into the plain
    model, with the fit-time targets."""
    jm, m, _ = models["plain"]
    x_new, y_new = _arrivals(5, 23)
    key = jax.random.PRNGKey(99)
    jys = jhmatrix.matvec(jm.factors, jm.alpha, XLA) + LAM * jm.alpha
    jf2, jys2, jrec = jupdate.insert(
        jm.factors, jnp.asarray(x_new), jm.kernel, key=key, config=XLA,
        y_new=jnp.asarray(y_new)[:, None], y_sorted=jys, jitter_rows=32)
    ys = hmatrix.matvec(m.factors, m.alpha) + LAM * m.alpha
    f2, ys2, rec = update.insert(
        m.factors, _t(x_new), m.kernel, y_new=_t(y_new)[:, None],
        y_sorted=ys, jitter_rows=32,
        **insert_draws(key, m.factors.num_leaves, jrec.k, 32))
    return jm, m, (jf2, jys2, jrec), (f2, ys2, rec)


def test_insert_matches_reference(inserted):
    _, m, (jf2, jys2, jrec), (f2, ys2, rec) = inserted
    assert rec.k == jrec.k and rec.base_leaf_size == jrec.base_leaf_size
    np.testing.assert_array_equal(rec.counts, np.asarray(jrec.counts))
    np.testing.assert_array_equal(rec.real_rows, jrec.real_rows)
    assert f2.leaf_size == 32 + rec.k and int(rec.counts.sum()) == 23
    np.testing.assert_array_equal(f2.x_sorted.numpy(), np.asarray(jf2.x_sorted))
    _fields_close(f2, jf2)
    _close(ys2, jys2)
    for field in ("landmarks", "sigma", "sigma_cho", "w"):
        assert all(a is b for a, b in zip(getattr(f2, field),
                                          getattr(m.factors, field)))


def test_insert_with_the_models_leaf_linv(inserted):
    """The cached ``leaf_linv`` gives the same extension as the one insert
    computes itself."""
    _, m, _, (f2, _, rec) = inserted
    x_new, _ = _arrivals(5, 23)
    draws = insert_draws(jax.random.PRNGKey(99), m.factors.num_leaves, rec.k,
                         32)
    f3, _, _ = update.insert(m.factors, _t(x_new), m.kernel,
                             linv_leaf=m.leaf_linv, jitter_rows=32, **draws)
    assert torch.equal(f3.u, f2.u) and torch.equal(f3.adiag, f2.adiag)
    assert m.leaf_linv is m.leaf_linv                  # cached


def test_downdate_insert_roundtrip_bitwise(inserted):
    _, m, _, (f2, _, rec) = inserted
    back = update.downdate(f2, rec.k)
    for field in ("x_sorted", "u", "adiag"):
        assert torch.equal(getattr(back, field), getattr(m.factors, field))
    assert torch.equal(back.tree.perm, m.factors.tree.perm)
    assert update.downdate(f2, 0) is f2
    with pytest.raises(ValueError, match="cannot remove"):
        update.downdate(f2, f2.leaf_size)


def test_refit_frozen_matches_reference_and_insert(inserted):
    _, m, (jf2, _, _), (f2, _, _) = inserted
    jref = jupdate.refit_frozen(jf2, JKernel("gaussian", SIGMA, JITTER), XLA,
                                jitter_rows=32)
    ref = update.refit_frozen(f2, m.kernel, jitter_rows=32)
    _fields_close(ref, jref)
    _fields_close(f2, jref)            # the insert equals the rebuild


def test_extension_blocks_and_invert_extend(inserted):
    jm, m, (jf2, _, _), (f2, _, _) = inserted
    jb, jc = jhmatrix.extension_blocks(jf2, n0_base=32, ridge=LAM)
    b, c = hmatrix.extension_blocks(f2, n0_base=32, ridge=LAM)
    _close(b, jb)
    _close(c, jc)
    inv, lo = hmatrix.invert_extend(f2, m.leaf_lo, m.inverse.linv,
                                    n0_base=32, ridge=LAM)
    jinv, jlo = jhmatrix.invert_extend(jf2, jm.leaf_lo, jm.inverse.linv,
                                       n0_base=32, ridge=LAM, config=XLA)
    full, flo = hmatrix.invert_with_leaf(f2, LAM)
    assert torch.equal(lo[:, :32, :32], m.leaf_lo)
    for want_inv, want_lo in ((jinv, jlo), (full, flo)):
        _close(lo, want_lo)
        for field in ("adiag", "u", "linv", "logabsdet"):
            _close(getattr(inv, field), getattr(want_inv, field), 1e-9)
    same, slo = hmatrix.invert_extend(m.factors, m.leaf_lo, m.inverse.linv,
                                      n0_base=32, ridge=LAM)
    assert slo is m.leaf_lo
    _close(same.adiag, m.inverse.adiag)
    with pytest.raises(ValueError, match="smaller than base"):
        hmatrix.invert_extend(m.factors, m.leaf_lo, m.inverse.linv,
                              n0_base=40, ridge=LAM)


# ---------------------------------------------------------------------------
# fit_incremental
# ---------------------------------------------------------------------------

def _update_pair(models, tag, refresh, x_new, y_new, seed, **kw):
    """The reference's and the port's fit_incremental of one batch."""
    jm, m, _ = models[tag]
    key = jax.random.PRNGKey(seed)
    jm2, jinfo = jkrr.fit_incremental(jm, jnp.asarray(x_new),
                                      jnp.asarray(y_new), refresh=refresh,
                                      key=key, **kw)
    m2, info = m.update(
        x_new, y_new, refresh=refresh,
        **insert_draws(key, m.factors.num_leaves, jinfo.record.k,
                       m.factors.leaf_size), **kw)
    return jm2, jinfo, m2, info


@pytest.mark.parametrize("refresh", ["inverse", "exact"])
def test_fit_incremental_matches_reference(models, refresh):
    _, m, q = models["plain"]
    x_new, y_new = _arrivals(11, 17)
    jm2, jinfo, m2, info = _update_pair(models, "plain", refresh, x_new,
                                        y_new, 17)
    assert info.record.k == jinfo.record.k and info.iterations == 0
    assert info.converged and not info.needs_rebuild
    _fields_close(m2.factors, jm2.factors)
    _close(m2.alpha, jm2.alpha, 1e-8)
    _close(m2.predict(_t(q)), jm2.predict(jnp.asarray(q)), 1e-8)
    assert info.residual <= 1e-12 and jinfo.residual <= 1e-12
    assert m2.base_leaf_size == 32 and m2.leaf_linv is m.leaf_linv
    _close(m2.leaf_lo, jm2.leaf_lo)
    # a second round borders the first round's pair (jitter frozen at 32)
    x3, y3 = _arrivals(12, 9)
    jm3, jinfo3 = jkrr.fit_incremental(jm2, jnp.asarray(x3), jnp.asarray(y3),
                                       refresh=refresh,
                                       key=jax.random.PRNGKey(4))
    m3, _ = m2.update(x3, y3, refresh=refresh, **insert_draws(
        jax.random.PRNGKey(4), m2.factors.num_leaves, jinfo3.record.k,
        m2.factors.leaf_size))
    _close(m3.predict(_t(q)), jm3.predict(jnp.asarray(q)), 1e-8)


def test_fit_incremental_stale_matches_reference(models):
    """Warm-started PCG under the lifted stale inverse.  Its residual trace
    falls 4x to 28x per iteration here (the reference's: 1.9e-8 after 7
    iterations, 6.8e-10 after 8), so the stop at tol 1e-9 is decided with a
    margin of 32%: the port stops at the reference's iteration, and the two
    solutions agree to 1e-8.  Cold CG does not reach tol in 60 iterations
    in either package."""
    _, m, q = models["plain"]
    x_new, y_new = _arrivals(21, 16)
    jm2, jinfo, m2, info = _update_pair(models, "plain", "stale", x_new,
                                        y_new, 21, tol=1e-9, maxiter=60,
                                        measure_cold=True)
    assert info.converged and jinfo.converged
    assert info.iterations == jinfo.iterations >= 1
    assert info.cold_iterations == jinfo.cold_iterations
    assert info.iterations * 2 <= info.cold_iterations
    _close(m2.predict(_t(q)), jm2.predict(jnp.asarray(q)), 1e-8)
    assert m2.inverse is m.inverse and m2.leaf_lo is m.leaf_lo
    exact, _ = m.update(x_new, y_new, refresh="exact", **insert_draws(
        jax.random.PRNGKey(21), m.factors.num_leaves, info.record.k, 32))
    _close(m2.predict(_t(q)), exact.predict(_t(q)), 1e-6)


def test_fit_incremental_budgeted_model(models):
    """A budgeted model's update keeps its masks and zeroes the appended U
    rows' masked columns, as the reference's."""
    jm, m, q = models["budget"]
    assert m.factors.rank_mask is not None
    assert m.factors.ranks == jm.factors.ranks
    assert m.factors.ranks.min < m.factors.ranks.max
    x_new, y_new = _arrivals(31, 21)
    jm2, _, m2, _ = _update_pair(models, "budget", "inverse", x_new, y_new,
                                 31)
    assert m2.factors.rank_mask is m.factors.rank_mask
    mask = torch.repeat_interleave(m.factors.rank_mask[-1], 2, dim=0)
    assert not (m2.factors.u * (1 - mask)[:, None, :]).any()
    _fields_close(m2.factors, jm2.factors)
    _close(m2.predict(_t(q)), jm2.predict(jnp.asarray(q)), 1e-8)
    ref = update.refit_frozen(m2.factors, m.kernel, jitter_rows=64)
    _close(m2.factors.u, ref.u)


def test_rebuild_policy_flag(models):
    pol = update.RebuildPolicy(max_leaf_growth=0.5, max_warm_iters=20,
                               max_update_error=1e-4)
    ok = dict(base_leaf_size=32, leaf_size=40)
    assert not pol.should_rebuild(**ok)
    assert pol.should_rebuild(base_leaf_size=32, leaf_size=49)
    assert pol.should_rebuild(**ok, warm_iters=21)
    assert not pol.should_rebuild(**ok, warm_iters=20)
    assert pol.should_rebuild(**ok, update_error=1e-3)
    assert not update.RebuildPolicy().should_rebuild(
        **ok, warm_iters=10**6, update_error=1.0)
    _, m, _ = models["plain"]
    x_new, y_new = _arrivals(41, 40)
    for growth, flag in ((0.05, True), (10.0, False)):
        _, info = m.update(x_new, y_new, generator=torch.Generator()
                           .manual_seed(0),
                           policy=update.RebuildPolicy(max_leaf_growth=growth))
        assert info.needs_rebuild is flag


def test_update_errors_and_empty_batch(models):
    _, m, _ = models["plain"]
    x_new, y_new = _arrivals(0, 3)
    with pytest.raises(ValueError, match="y_sorted"):
        update.insert(m.factors, _t(x_new), m.kernel, y_new=_t(y_new))
    with pytest.raises(ValueError, match="no fit ridge"):
        krr.fit_incremental(dataclasses.replace(m, lam=None), x_new, y_new)
    with pytest.raises(ValueError, match="refresh"):
        m.update(x_new, y_new, refresh="bogus")
    same, info = m.update(np.zeros((0, D)), np.zeros((0,)))
    assert same is m and info.record.k == 0 and info.converged
    xc = np.random.default_rng(2).standard_normal((64, D))
    clf = krr.fit(xc, (xc[:, 0] > 0).astype(np.int64), kernel=BaseKernel(),
                  lam=LAM, rank=4, leaf_size=16, classification=True,
                  device="cpu")
    with pytest.raises(ValueError, match="outside the fitted classes"):
        clf.update(xc[:2], np.array([0, 5]))
    m2, _ = clf.update(xc[:5], (xc[:5, 0] > 0).astype(np.int64))
    assert m2.factors.leaf_size > 16 and m2.predict_class(_t(xc[:4])).shape \
        == (4,)
