"""Rank 256, the reference benches' default (benchmarks/bench_build.py,
bench_oos.py and bench_sweep.py), and the panel forms of B1, B2, B3, B8 and
B9 that take it on the card.

Parity: the port's plain path at rank 256 with leaves of 256 (n 1,024, d
3, 2 levels, float64) -- build_hck, krr.fit and its predictions, and one
sigma of sweep_factors -- against the reference's xla backend, with the
reference's tree, landmark and padding draws injected (test_torch_build,
test_torch_fit), at 1e-10 relative.  The wrappers: with a recording launch
(``fake_card``) each launches its resident kernel up to its old limit and
its panel kernel past it, at phase 3r's ragged shapes, and raises naming
the panel form's limit past m 512 (factors) or r 256 (cross).  The
planners: every block the panel plans launch fits the shared memory.  The
panel kernels themselves run only on the card, where chip_smoke.py phase
3r holds them against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws, port_build
from test_torch_fit import reference_draws

from repro.core import hck as jhck
from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch.core import hck, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build
from repro_torch.kernels.build_stage import ops as build_ops
from repro_torch.kernels.hck_leaf import ops as leaf_ops

N, D, RANK, LEVELS = 1024, 3, 256, 2
SIGMA, JITTER, LAM = 1.5, 1e-3, 1e-2
F32, F64 = torch.float32, torch.float64
# phase 3r's ragged shapes (chip_smoke.py PANEL_M, PANEL_R)
PANEL_M = {F32: (236, 241, 300, 511, 512), F64: (164, 170, 256, 512)}
PANEL_R = (129, 200, 256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(30)
    x = rng.standard_normal((N, D))
    return x, np.sin(x).sum(axis=1), rng.standard_normal((37, D))


def test_rank256_build_fit_predict_match_reference(f64, data):
    """build_hck, krr.fit (alpha, the plan) and predict at rank 256 with
    leaves of 256, against the reference's krr.fit (xla)."""
    x, y, q = data
    key = jax.random.PRNGKey(31)
    ker, jker = (BaseKernel("gaussian", SIGMA, JITTER),
                 JKernel("gaussian", SIGMA, JITTER))
    m = jkrr.fit(jnp.asarray(x), jnp.asarray(y), kernel=jker, lam=LAM,
                 rank=RANK, key=key,
                 solve_config=JSolveConfig(backend="xla"))
    jf = m.factors
    assert jf.levels == LEVELS and jf.leaf_size == RANK
    _, kbuild = jax.random.split(key)
    f = port_build(jf, x, kbuild, ker, RANK)
    for field in ("landmarks", "sigma", "sigma_cho"):
        for got, want in zip(getattr(f, field), getattr(jf, field)):
            _close(got, want)
    _close(f.adiag, jf.adiag)
    _close(hck.to_dense(f), jhck.to_dense(jf))
    pm = krr.fit(x, y, kernel=ker, lam=LAM, rank=RANK, device="cpu",
                 directions=[_t(v) for v in jf.tree.directions],
                 **reference_draws(key, x, RANK, LEVELS, RANK))
    assert pm.factors.leaf_size == RANK and pm.factors.levels == LEVELS
    np.testing.assert_array_equal(pm.factors.tree.perm.numpy(),
                                  np.asarray(jf.tree.perm))
    _close(pm.alpha, m.alpha)
    _close(pm.plan.w_leaf, m.plan.w_leaf)
    _close(pm.plan.c_tilde, m.plan.c_tilde)
    _close(pm.predict(_t(q)), m.predict(jnp.asarray(q)))


def test_rank256_sweep_factors_match_reference(f64, data):
    """One sigma of sweep_factors at rank 256, leaves of 256, against the
    reference's (xla) on the reference's tree and landmarks."""
    x = data[0]
    key = jax.random.PRNGKey(32)
    jp = jhck.build_sweep_plan(jnp.asarray(x), levels=LEVELS, rank=RANK,
                               key=key)
    p = hck.build_sweep_plan(
        _t(x), levels=LEVELS, rank=RANK, device="cpu",
        directions=[_t(v) for v in jp.tree.directions],
        landmark_index=landmark_draws(key, N, LEVELS, RANK))
    jf = jhck.sweep_factors(jp, JKernel("gaussian", SIGMA, JITTER),
                            JSolveConfig(backend="xla"))
    f = hck.sweep_factors(p, BaseKernel("gaussian", SIGMA, JITTER))
    assert f.rank == RANK and f.leaf_size == RANK
    for field in ("sigma", "sigma_cho"):
        for got, want in zip(getattr(f, field), getattr(jf, field)):
            _close(got, want)
    _close(f.adiag, jf.adiag)
    _close(hck.to_dense(f), jhck.to_dense(jf))


# ---------------------------------------------------------------------------
# The wrappers' choice of form, with a recording launch
# ---------------------------------------------------------------------------

WRAPPERS = (build_ops.build_gram, build_ops.build_gram_levels,
            build_ops.build_cross, build_ops.build_cross_levels,
            build_ops.build_gram_dist, build_ops.build_gram_dist_levels,
            build_ops.build_cross_dist, build_ops.build_cross_dist_levels,
            leaf_ops.leaf_factor)


@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrappers' card path: the device check
    passes them and the launch records (library, symbol, args); the
    counters of the wrappers with a panel form start at 0."""
    calls = []
    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, dev, *args:
                        calls.append((name, symbol, args)))
    for fn in WRAPPERS:
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "panel_launches", 0)
    return calls


def _sfx(dtype):
    return _build.SUFFIX[dtype]


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_leaf_factor_resident_then_panel(fake_card, dtype):
    """B3: the resident kernel up to n0 240 (f32) / 169 (f64), the panel
    kernel past it up to 512, a raise naming the panel form's limit past
    512, before any launch."""
    old = {F32: 240, F64: 169}[dtype]
    for n0 in (old, *PANEL_M[dtype]):
        leaf_ops.leaf_factor(torch.zeros((2, n0, n0), dtype=dtype))
        lib = "leaf_factor" if n0 <= old else "leaf_factor_panel"
        assert fake_card[-1][:2] == (lib, f"{lib}_{_sfx(dtype)}")
        assert fake_card[-1][2][3:] == (2, n0)
    assert leaf_ops.leaf_factor.launches == 1 + len(PANEL_M[dtype])
    assert leaf_ops.leaf_factor.panel_launches == sum(
        m > old for m in PANEL_M[dtype])
    with pytest.raises(ValueError, match="above m = 512.*panel form"):
        leaf_ops.leaf_factor(torch.zeros((1, 513, 513), dtype=dtype))
    assert len(fake_card) == 1 + len(PANEL_M[dtype])


@pytest.mark.parametrize("dist", [False, True], ids=["B1", "B8"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_gram_levels_resident_then_panel(fake_card, dtype, dist):
    """B1 (points) and B8 (cached distances): levels whose factored tile
    fits the resident kernel (m 24, the old limit and, for B8, m 236 in f32
    and 164 in f64) in one launch, those past it in one launch of the
    panel kernel; a
    launch without factors (B1's Adiag) stays resident at any m; m 513
    raises naming the panel form's limit, before any launch."""
    old = {(F32, False): 235, (F64, False): 163, (F32, True): 240,
           (F64, True): 169}[dtype, dist]
    ms = (24, old, *PANEL_M[dtype])
    if dist:
        fn, lib = build_ops.build_gram_dist_levels, "build_dist"
        sym = "gram_chol_dist_levels"
        args = [torch.zeros((1, m, m), dtype=dtype) for m in ms]
    else:
        fn, lib, sym = build_ops.build_gram_levels, "build_stage", \
            "gram_chol_levels"
        args = [torch.zeros((1, m, 3), dtype=dtype) for m in ms]
    out = fn(args)
    assert len(out) == len(ms) and all(c.shape[1] == m
                                       for (_, c), m in zip(out, ms))
    (rl, rs, ra), (pl, ps, pa) = fake_card
    assert (rl, rs) == (lib, f"{sym}_{_sfx(dtype)}")
    assert (pl, ps) == (f"{lib}_panel", f"{sym}_panel_{_sfx(dtype)}")
    assert ra[0][:, -1].tolist() == [m for m in ms if m <= old]
    assert pa[0][:, -1].tolist() == [m for m in ms if m > old]
    assert ra[1] == sum(m <= old for m in ms)
    assert pa[1] == sum(m > old for m in ms)
    assert fn.launches == 2 and fn.panel_launches == 1
    if not dist:                       # the Adiag: no factor, no limit
        build_ops.build_gram(torch.zeros((2, 512, 3), dtype=dtype),
                             want_chol=False)
        assert fake_card[-1][:2] == (lib, f"{sym}_{_sfx(dtype)}")
        assert build_ops.build_gram.panel_launches == 0
    big = (torch.zeros((1, 513, 513), dtype=dtype) if dist
           else torch.zeros((1, 513, 3), dtype=dtype))
    n = len(fake_card)
    with pytest.raises(ValueError, match="above m = 512.*panel form"):
        fn([args[0], big])
    assert len(fake_card) == n


@pytest.mark.parametrize("dist", [False, True], ids=["B2", "B9"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_cross_levels_resident_then_panel(fake_card, dtype, dist):
    """B2 and B9: rank 128 on the resident kernel, phase 3r's PANEL_R on
    the panel kernel (no row-tile argument: its tile is fixed), rank 257
    raising naming the panel form's limit, before any launch; bfloat16
    data past rank 128 on the panel form's bfloat16-data entry."""
    lib, sym = (("build_dist", "cross_solve_dist_levels") if dist
                else ("build_stage", "cross_solve_levels"))
    fn = (build_ops.build_cross_dist_levels if dist
          else build_ops.build_cross_levels)

    def call(r, data_dtype=dtype):
        ms = (48, 130, 512)
        li = [torch.zeros((2, r, r), dtype=dtype if data_dtype != torch
                          .bfloat16 else F32) for _ in ms]
        if dist:
            return fn([torch.zeros((2, m, r), dtype=data_dtype)
                       for m in ms], li)
        return fn([torch.zeros((2, m, 3), dtype=data_dtype) for m in ms],
                  [torch.zeros((2, r, 3), dtype=data_dtype) for _ in ms], li)

    call(128)
    assert fake_card[-1][:2] == (lib, f"{sym}_{_sfx(dtype)}")
    for r in PANEL_R:
        us = call(r)
        assert [u.shape[1:] for u in us] == [(m, r) for m in (48, 130, 512)]
        name, symbol, args = fake_card[-1]
        assert (name, symbol) == (f"{lib}_panel",
                                  f"{sym}_panel_{_sfx(dtype)}")
        assert args[1:3] == (3, r)
    assert fn.launches == 1 + len(PANEL_R)
    assert fn.panel_launches == len(PANEL_R)
    n = len(fake_card)
    with pytest.raises(ValueError, match="r=257 is above 256.*panel form"):
        call(257)
    assert len(fake_card) == n
    if dtype == F32:
        call(129, torch.bfloat16)
        assert fake_card[-1][:2] == (f"{lib}_panel_bf16",
                                     f"{sym}_panel_bf16")


# ---------------------------------------------------------------------------
# The planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_panel_plans_fit_shared_memory(itemsize):
    """Every shape a panel plan accepts launches a block within the shared
    memory a block can have: the factor's (B3, B8) and B1's (the factor's
    and the point staging) up to m 512, and the cross kernels' at every
    rank up to 256; the planners name the panel form exactly past the
    resident forms' shared memory, and the f64 cross tiles' row height is
    the panel form's one height past rank 128."""
    for m in range(1, leaf_ops.PANEL_MAX_M + 1):
        assert leaf_ops.panel_smem(m, itemsize) <= _build.SMEM_MAX
        assert build_ops.gram_panel_smem(m, itemsize) <= _build.SMEM_MAX
        assert (leaf_ops.factor_route("t", m, itemsize, leaf_ops.factor_smem)
                == ("panel" if leaf_ops.factor_smem(m, itemsize)
                    > _build.SMEM_MAX else "resident"))
        assert (build_ops.gram_route("t", m, itemsize) == "panel") == (
            build_ops.gram_smem(m, itemsize) > _build.SMEM_MAX)
    assert build_ops.cross_panel_smem(itemsize) <= _build.SMEM_MAX
    for r in range(1, build_ops.MAX_CROSS_RANK + 1):
        panel = r > build_ops.RESIDENT_CROSS_RANK
        assert build_ops.cross_route("t", r, itemsize) == (
            "panel" if panel else "resident")
        if panel:
            assert build_ops.row_tiles(r, itemsize) == [
                build_ops.PANEL_ROWS[itemsize]]
    assert build_ops.cross_rows(512, 256, itemsize) == \
        build_ops.PANEL_ROWS[itemsize]
    with pytest.raises(ValueError, match="row tile 16 is not one of"):
        build_ops.cross_rows(512, 256, itemsize, row_tile=16)
