"""Port parity: the HCK build (repro_torch.core.hck) and its two stages.

The same numpy inputs go through the JAX reference in float64 -- its
``xla`` path and its Pallas kernels in interpret mode -- and through the
port's plain PyTorch path on the CPU.  Random draws do not cross
frameworks, so the partition directions and the per-level landmark row
indices are taken from the reference's key chain and injected.
Tolerance 1e-10 relative (to the largest entry).  The CUDA kernels run only
on the card, where chip_smoke.py holds them against these plain versions.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hck as jhck
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.build_stage import ops as jbuild_ops
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.kernels.registry import get_impl as jget_impl
from repro_torch.core import hck
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build, registry
from repro_torch.kernels.build_stage import ops as build_ops
from repro_torch.kernels.build_stage.ref import build_cross_ref, build_gram_ref

KERNELS = ["gaussian", "imq", "laplace"]
N, D, RANK, LEAF, LEVELS = 512, 3, 8, 16, 5
SIGMA, JITTER = 1.5, 1e-8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def landmark_draws(kbuild, n, levels, rank):
    """The reference build's landmark row indices, per level (2**l, r):
    ``kpart, key = split(kbuild)``, then one ``key, sub = split(key)`` per
    level."""
    _, key = jax.random.split(kbuild)
    out = []
    for lvl in range(levels):
        key, sub = jax.random.split(key)
        out.append(_t(jhck.landmark_indices(sub, 1 << lvl, n >> lvl, rank)))
    return out


def port_build(jf, x, kbuild, kernel, rank, **kw):
    """The port's build_hck on ``x`` with the tree and landmarks of the
    reference build ``jf`` (made with key ``kbuild``)."""
    return hck.build_hck(
        _t(x), levels=jf.levels, rank=rank, kernel=kernel,
        directions=[_t(v) for v in jf.tree.directions],
        landmark_index=landmark_draws(kbuild, x.shape[0], jf.levels, rank),
        **kw)


# ---------------------------------------------------------------------------
# B1 build_gram and B2 build_cross: plain versions vs the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("want_chol", [True, False], ids=["chol", "gram"])
@pytest.mark.parametrize("name", KERNELS)
def test_build_gram_matches_reference(f64, name, want_chol):
    pts = np.random.default_rng(0).standard_normal((6, 12, D))
    opts = dict(name=name, sigma=SIGMA, jitter=1e-3, want_chol=want_chol)
    wants = [jget_impl("build_gram", "xla")(jnp.asarray(pts), **opts),
             jbuild_ops.build_gram(jnp.asarray(pts), interpret=True, **opts)]
    before = build_ops.build_gram.launches
    for got in (build_gram_ref(_t(pts), **opts),
                build_ops.build_gram(_t(pts), **opts)):
        for want in wants:
            _close(got[0], want[0])
            if want_chol:
                _close(got[1], want[1])
            else:
                assert got[1] is None and want[1] is None
    assert build_ops.build_gram.launches == before


@pytest.mark.parametrize("name", KERNELS)
def test_build_cross_matches_reference(f64, name):
    rng = np.random.default_rng(1)
    pts, lm = rng.standard_normal((4, 32, D)), rng.standard_normal((4, 8, D))
    a = rng.standard_normal((4, 8, 8))
    linv = np.tril(a) + 4 * np.eye(8)
    args = tuple(map(jnp.asarray, (pts, lm, linv)))
    wants = [jget_impl("build_cross", "xla")(*args, name=name, sigma=SIGMA),
             jbuild_ops.build_cross(*args, name=name, sigma=SIGMA,
                                    interpret=True)]
    before = build_ops.build_cross.launches
    for got in (build_cross_ref(_t(pts), _t(lm), _t(linv), name=name,
                                sigma=SIGMA),
                build_ops.build_cross(_t(pts), _t(lm), _t(linv), name=name,
                                      sigma=SIGMA)):
        for want in wants:
            _close(got, want)
    assert build_ops.build_cross.launches == before


def test_singular_block_gives_nan(f64):
    """No pivot clamp: a block that is not positive definite gives NaN, as
    the reference's Cholesky does, not an exception or a clamped factor."""
    pts = np.random.default_rng(2).standard_normal((3, 6, D))
    pts[1, 3] = pts[1, 0]                       # block 1: a repeated point
    want = jget_impl("build_gram", "xla")(jnp.asarray(pts), jitter=0.0)[1]
    gram, chol = build_gram_ref(_t(pts), jitter=0.0)
    assert torch.isfinite(gram).all()
    np.testing.assert_array_equal(np.isnan(chol.numpy()),
                                  np.isnan(np.asarray(want)))
    assert torch.isnan(chol[1]).any()
    _close(chol[[0, 2]], np.asarray(want)[[0, 2]])


def test_wrappers_reject_bad_shapes_and_oversized_tiles():
    with pytest.raises(ValueError, match="build_gram"):
        build_ops.build_gram(torch.zeros(4, 5))
    with pytest.raises(ValueError, match="unknown base kernel"):
        build_ops.build_gram(torch.zeros(2, 4, 3), name="cauchy")
    with pytest.raises(ValueError, match="build_cross"):
        build_ops.build_cross(torch.zeros(2, 8, 3), torch.zeros(2, 4, 3),
                              torch.zeros(2, 3, 3))
    # covtype width fits one block; an r = 256 Gram tile takes the panel
    # form, whose block fits
    assert build_ops.gram_smem(128, 8) <= _build.SMEM_MAX
    assert build_ops.gram_smem(256, 4) > _build.SMEM_MAX
    assert build_ops.gram_route("t", 256, 4) == "panel"
    assert build_ops.gram_panel_smem(256, 4) <= _build.SMEM_MAX
    assert build_ops.cross_rows(256, 128, 4) == 128
    assert build_ops.cross_rows(256, 128, 8) == 32
    assert build_ops.cross_rows(16, 8, 8) == 16
    # rank 256 takes the panel form's one tile height; past 256 it raises
    assert build_ops.cross_rows(512, 256, 4) == build_ops.PANEL_ROWS[4]
    for r in (257, 2048):
        with pytest.raises(ValueError, match="panel form"):
            build_ops.cross_rows(512, r, 4)


# ---------------------------------------------------------------------------
# build_hck against the reference engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return np.random.default_rng(3).standard_normal((N, D))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("name", KERNELS)
def test_build_hck_matches_reference(f64, data, name, backend):
    kbuild = jax.random.PRNGKey(4)
    jf = jhck.build_hck(jnp.asarray(data), levels=LEVELS, rank=RANK,
                        key=kbuild, kernel=JKernel(name, SIGMA, JITTER),
                        config=JSolveConfig(backend=backend, interpret=True))
    f = port_build(jf, data, kbuild, BaseKernel(name, SIGMA, JITTER), RANK)
    np.testing.assert_array_equal(f.tree.perm.numpy(), np.asarray(jf.tree.perm))
    np.testing.assert_array_equal(f.x_sorted.numpy(), np.asarray(jf.x_sorted))
    for field in ("landmarks", "sigma", "sigma_cho"):
        for got, want in zip(getattr(f, field), getattr(jf, field)):
            _close(got, want)
    _close(f.adiag, jf.adiag)
    # U and W are amplified by kappa(Sigma): held at the operator level
    _close(hck.to_dense(f), jhck.to_dense(jf))
    assert f.rank_mask is None and f.levels == LEVELS


def test_build_hck_matches_per_node_reference(f64, data):
    kbuild = jax.random.PRNGKey(5)
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    jf = jhck.build_hck(jnp.asarray(data), levels=LEVELS, rank=RANK,
                        key=kbuild, kernel=JKernel("gaussian", SIGMA, JITTER))
    draws = dict(directions=[_t(v) for v in jf.tree.directions],
                 landmark_index=landmark_draws(kbuild, N, LEVELS, RANK))
    f = hck.build_hck(_t(data), levels=LEVELS, rank=RANK, kernel=ker, **draws)
    ref = hck.build_hck_reference(_t(data), levels=LEVELS, rank=RANK,
                                  kernel=ker, **draws)
    for field in ("sigma", "sigma_cho", "w"):
        for got, want in zip(getattr(f, field), getattr(ref, field)):
            _close(got, want, 1e-8)
    _close(f.u, ref.u, 1e-8)
    _close(f.adiag, ref.adiag)
    _close(hck.to_dense(f), hck.to_dense(ref))


def test_build_hck_levels0(f64):
    x = np.random.default_rng(6).standard_normal((32, D))
    jf = jhck.build_hck(jnp.asarray(x), levels=0, rank=4,
                        key=jax.random.PRNGKey(1),
                        kernel=JKernel("imq", SIGMA, JITTER))
    f = hck.build_hck(_t(x), levels=0, rank=4,
                      kernel=BaseKernel("imq", SIGMA, JITTER))
    assert f.levels == 0 and f.rank == 0 and f.u.shape == (1, 32, 0)
    _close(f.adiag, jf.adiag)
    _close(hck.to_dense(f), jhck.to_dense(jf))


def test_own_landmark_draws_are_distinct_rows_of_each_node(data):
    gen = torch.Generator().manual_seed(0)
    f = hck.build_hck(_t(data), levels=4, rank=RANK, kernel=BaseKernel(),
                      generator=gen)
    for lvl, lm in enumerate(f.landmarks):
        blocks = f.x_sorted.reshape(1 << lvl, N >> lvl, D)
        for node in range(1 << lvl):
            # each landmark is a row of its node's block, no row twice
            match = (lm[node][:, None, :] == blocks[node][None]).all(-1)
            assert (match.sum(1) >= 1).all()
            assert torch.unique(lm[node], dim=0).shape[0] == RANK


def test_unported_build_options_raise():
    """No build option raises any more: a mixed-precision build (ROADMAP
    A15a) runs on the tree and landmarks of the dtype-preserving build,
    its factors in the policy's factor dtype (its bounds against the
    reference are in tests/test_torch_mixed_precision.py), and the
    landmark-policy options, ported with A10, build (their parity with
    the reference is in tests/test_torch_landmarks.py)."""
    ker = BaseKernel()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, D)))
    plain = hck.build_hck(x, levels=2, rank=4, kernel=ker,
                          generator=torch.Generator().manual_seed(3))
    for prec, dt in (("bf16", torch.float32), ("f32", torch.float32),
                     ("f64", torch.float64)):
        f = hck.build_hck(x, levels=2, rank=4, kernel=ker,
                          config=registry.SolveConfig(precision=prec),
                          generator=torch.Generator().manual_seed(3))
        assert torch.equal(f.tree.perm, plain.tree.perm)
        assert all(torch.equal(a, b)
                   for a, b in zip(f.landmarks, plain.landmarks))
        assert f.x_sorted.dtype == torch.float64
        assert f.u.dtype == f.adiag.dtype == f.sigma[0].dtype == dt
        assert torch.isfinite(f.u).all()
    for kw in (dict(method="pca"), dict(shared_landmarks=True),
               dict(policy="kmeans"), dict(rank_budget=40)):
        f = hck.build_hck(x, levels=2, rank=4, kernel=ker, **kw)
        assert f.levels == 2 and torch.isfinite(f.u).all()
        assert (f.rank_mask is not None) == ("rank_budget" in kw)


def test_forced_backend_on_the_other_device_raises():
    """A forced backend never runs on a tensor of the other device.  A
    stand-in carries a CUDA device (the stage reads only ``.device``)."""
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    for stage in ("build_gram", "build_cross", "leaf_factor", "leaf_matvec",
                  "leaf_solve"):
        assert registry.resolve_backend(None, stage, on_card) == "cuda"
        with pytest.raises(ValueError, match="CPU tensors only"):
            registry.resolve_backend(registry.SolveConfig(backend="torch"),
                                     stage, on_card)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            registry.resolve_backend(registry.SolveConfig(backend="cuda"),
                                     stage, torch.zeros(2))
        assert callable(registry.get_impl(stage, "cuda"))
