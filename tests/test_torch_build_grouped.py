"""The build engine's grouped kernels: B1 ``gram_chol_levels`` (every
level's Sigma with its factor in one launch; the leaf Adiag blocks in a
launch without one) and B2 ``cross_solve_levels`` (U and every level's W
in one launch; float32 in split TF32 on the tensor cores), both in
``csrc/build_stage.cu``.

No card is needed.  The kernels' arithmetic is emulated on the CPU: B1 as
B3's blocked factor (``blocked_factor`` of
``test_torch_leaf_policy_redesign.py``) on the Gram of the direct-sum
distances; B2 as the direct-sum distances in float32 followed by B9's
split-TF32 products (``_b9_emulated`` of ``test_torch_sweep_kernels.py``,
the products both kernels share in ``csrc/cross_tc.cuh``), three passes
and, as the control, one.  Both are held against the reference's Pallas
kernels in interpret mode.  The wrappers' card path is followed with the
launch replaced by a recorder (one launch per grouped call, its table of
groups), and the grouped plain versions equal the per-level ones bit for
bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_leaf_policy_redesign import blocked_factor
from test_torch_sweep_kernels import _b9_emulated, _points, _sigma_linv

from repro.kernels.build_stage import ops as jbuild_ops
from repro_torch.core import hck
from repro_torch.core.kernels_fn import (BaseKernel, get_kernel,
                                          kernel_epilogue)
from repro_torch.kernels import _build
from repro_torch.kernels.build_stage import ops as build_ops
from repro_torch.kernels.build_stage.ref import (build_cross_levels_ref,
                                                 build_cross_ref,
                                                 build_gram_levels_ref,
                                                 build_gram_ref, direct_dist)

KERNELS = ["gaussian", "imq", "laplace"]
METRIC = {"gaussian": "l2", "imq": "l2", "laplace": "l1"}
# test_torch_build.py's sizes
N, D, RANK, LEAF, LEVELS = 512, 3, 8, 16, 5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# (a) B1: B3's blocked factor on the direct-sum Gram
# ---------------------------------------------------------------------------

def _b1_emulated(pts, name, sigma, jitter):
    """The grouped kernel's output: the Gram of the direct-sum distances
    (the epilogue, jitter m on the diagonal, in the points' dtype) and its
    blocked factor."""
    m = pts.shape[1]
    dist = direct_dist(pts, pts, METRIC[name])
    gram = kernel_epilogue(name, sigma)(dist) + jitter * m * torch.eye(
        m, dtype=pts.dtype)
    return gram, blocked_factor(gram)[0]


@pytest.mark.parametrize("dtype, rtol", [(np.float32, 1e-4),
                                         (np.float64, 1e-10)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", KERNELS)
def test_b1_blocked_emulation(f64, name, dtype, rtol):
    """The Gram within 1e-6 (f32) of the reference's gram_chol kernel
    (interpret mode), exactly symmetric, and its blocked factor within
    chip_smoke.py's gate of the reference's factor and of the plain
    version's."""
    m = 96 if dtype == np.float32 else 40
    pts = _points(np.random.default_rng(m), (2, m)).astype(dtype)
    opts = dict(name=name, sigma=1.0, jitter=1e-3)
    gram, lo = _b1_emulated(torch.from_numpy(pts), **opts)
    jg, jl = jbuild_ops.build_gram(jnp.asarray(pts), want_chol=True,
                                   interpret=True, **opts)
    assert jl.dtype == dtype
    pg, pl = build_gram_ref(torch.from_numpy(pts), **opts)
    assert torch.equal(gram, gram.mT)
    assert _rel(gram, jg) <= max(rtol, 1e-6)
    assert lo.dtype == pg.dtype and not lo.triu(1).any()
    assert _rel(lo, jl) <= rtol, _rel(lo, jl)
    assert _rel(lo, pl) <= rtol, _rel(lo, pl)


# ---------------------------------------------------------------------------
# (b) B2: direct-sum distances, then split TF32 on the tensor cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b, m, r, d", [(2, 256, 128, 54), (3, 40, 12, 5)],
                         ids=["covtype", "ragged"])
def test_b2_split_tf32_meets_the_gate(f64, b, m, r, d):
    """Three passes within chip_smoke.py's componentwise gate, |dU| <=
    4 (2r + d) eps32 |K||Linv^T||Linv|, of the reference's cross_solve
    kernel (interpret mode) in float64 on the same float32 inputs; one
    pass, the control, fails it."""
    rng = np.random.default_rng(r + d)
    pts = _points(rng, (b, m), d).astype(np.float32)
    lm = _points(rng, (b, r), d).astype(np.float32)
    linv = _sigma_linv(rng, b, r).astype(np.float32)
    dist = direct_dist(torch.from_numpy(pts), torch.from_numpy(lm),
                       "l2").numpy()
    assert dist.dtype == np.float32
    want = np.asarray(jbuild_ops.build_cross(
        jnp.asarray(pts, jnp.float64), jnp.asarray(lm, jnp.float64),
        jnp.asarray(linv, jnp.float64), sigma=1.0, interpret=True))
    assert want.dtype == np.float64
    kabs = np.abs(get_kernel("gaussian")(
        torch.from_numpy(pts).double(), torch.from_numpy(lm).double(),
        sigma=1.0).numpy())
    gate = (4 * (2 * r + d) * np.finfo(np.float32).eps
            * ((kabs @ np.abs(np.swapaxes(linv, 1, 2))) @ np.abs(linv)))
    three = np.abs(_b9_emulated(dist, linv, "gaussian", 1.0, 3) - want)
    one = np.abs(_b9_emulated(dist, linv, "gaussian", 1.0, 1) - want)
    print(f"B2 emulated (b {b}, m {m}, r {r}, d {d}), max |dU| / gate: "
          f"three passes {(three / gate).max():.3e}, one pass "
          f"{(one / gate).max():.3e}")
    assert (three / gate).max() <= 1.0
    assert (one / gate).max() > 1.0


# ---------------------------------------------------------------------------
# (c) The grouped plain versions are the per-level ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_grouped_plain_versions_equal_per_level_bit_for_bit(name, dtype):
    rng = np.random.default_rng(9)
    lms = [torch.from_numpy(_points(rng, (1 << lvl, 8), d=D)).to(dtype)
           for lvl in range(3)]
    leaves = torch.from_numpy(_points(rng, (8, 10), d=D)).to(dtype)
    opts = dict(name=name, sigma=0.8)
    grouped = build_gram_levels_ref(lms, jitter=1e-3, **opts)
    grouped += build_gram_levels_ref([leaves], jitter=1e-3,
                                     want_chol=False, **opts)
    for (g, c), p in zip(grouped, lms + [leaves]):
        pg, pc = build_gram_ref(p, jitter=1e-3, want_chol=c is not None,
                                **opts)
        assert torch.equal(g, pg)
        assert (c is None and pc is None) or torch.equal(c, pc)
    assert grouped[-1][1] is None
    linvs = [hck.sigma_linv(c) for _, c in grouped[:3]]
    points = [leaves.reshape(4, 20, D)] + [
        lms[lvl].reshape(1 << (lvl - 1), 16, D) for lvl in range(1, 3)]
    parents = [lms[2][:4], lms[0], lms[1]]
    cross_linvs = [linvs[2][:4], linvs[0], linvs[1]]
    got = build_cross_levels_ref(points, parents, cross_linvs, **opts)
    for u, p, z, li in zip(got, points, parents, cross_linvs):
        assert torch.equal(u, build_cross_ref(p, z, li, **opts))
    # on CPU tensors the wrappers run the same plain versions, no launch
    before = (build_ops.build_gram_levels.launches,
              build_ops.build_cross_levels.launches)
    wg = build_ops.build_gram_levels(lms, jitter=1e-3, **opts)
    wg += build_ops.build_gram_levels([leaves], jitter=1e-3,
                                      want_chol=False, **opts)
    wc = build_ops.build_cross_levels(points, parents, cross_linvs, **opts)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(wg, grouped))
    assert all(torch.equal(a, b) for a, b in zip(wc, got))
    assert (build_ops.build_gram_levels.launches,
            build_ops.build_cross_levels.launches) == before


# ---------------------------------------------------------------------------
# (d) The wrappers' card path, the launch recorded
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrappers' card path: the device check
    passes them and the launch records (library, symbol, args, the
    table's rows of tensors).  The recorder fills the outputs with values
    a build can go on from: a factor C = I + 0.05 tril(1, -1) and its
    Gram C C^T (an identity Gram without a factor), zero U."""
    calls, rows = [], []
    table = build_ops.level_table

    def recording_table(stage, rs):
        rows.append(rs)
        return table(stage, rs)

    def launch(name, symbol, dev, *args):
        group_rows = rows[-1] if args and isinstance(args[0], torch.Tensor) \
            and args[0].dtype == torch.int64 else None
        calls.append((name, symbol, args, group_rows))
        for row in group_rows or ():
            if symbol.startswith("cross"):
                row[3].zero_()
            elif row[2] is None:
                row[1].copy_(torch.eye(row[1].shape[-1]))
            else:
                row[2].copy_(_factor(row[2].shape[-1]))
                row[1].copy_(_factor(row[2].shape[-1]) @ _factor(
                    row[2].shape[-1]).T)

    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(build_ops, "level_table", recording_table)
    for fn in (build_ops.build_gram, build_ops.build_cross,
               build_ops.build_gram_levels, build_ops.build_cross_levels):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(hck, "resolve_backend",
                        lambda config, stage, *ts: "cuda")
    return calls


def _ptrs(t):
    return t.data_ptr()


def _factor(m):
    return torch.eye(m, dtype=torch.float64) + 0.05 * torch.ones(
        (m, m), dtype=torch.float64).tril(-1)


@pytest.mark.parametrize("budget", [None, 40])
def test_build_hck_launches_and_tables(fake_card, monkeypatch, budget):
    """build_hck on the card's route: one grouped gram_chol_levels launch
    (every level's Sigma with a factor), one gram_chol_levels launch of
    one group without a factor (the leaves' Adiag) and one grouped
    cross_solve_levels launch (U of the paired leaves, then W of levels
    1..L-1), each table row the level's tensors; with a rank budget the
    B2 launch reads the identity-padded Linv of _apply_rank_masks."""
    masked = []
    apply_masks = hck._apply_rank_masks

    def recording_masks(*args):
        out = apply_masks(*args)
        masked.append(out[2])
        return out

    monkeypatch.setattr(hck, "_apply_rank_masks", recording_masks)
    x = torch.from_numpy(_points(np.random.default_rng(3), (N,), d=D))
    f = hck.build_hck(x, levels=LEVELS, rank=RANK, rank_budget=budget,
                      kernel=BaseKernel("gaussian", 1.0, 1e-3),
                      generator=torch.Generator().manual_seed(0))
    assert [c[1] for c in fake_card] == ["gram_chol_levels_f64"] * 2 + [
        "cross_solve_levels_f64"]
    assert build_ops.build_gram_levels.launches == 1
    assert build_ops.build_gram.launches == 1
    assert build_ops.build_cross_levels.launches == 1
    assert build_ops.build_cross.launches == 0
    (_, _, gargs, grows), (_, _, aargs, _), (_, _, cargs, crows) = fake_card
    gtable, ctable = gargs[0], cargs[0]
    assert gargs[1:] == (LEVELS, D, _build.EPILOGUE_KIND["gaussian"], 1.0,
                         1e-3, 1)
    assert gtable.tolist() == [
        [_ptrs(f.landmarks[lvl]), _ptrs(f.sigma[lvl]) if budget is None
         else grows[lvl][1].data_ptr(), grows[lvl][2].data_ptr(), 1 << lvl,
         RANK] for lvl in range(LEVELS)]
    assert aargs[0].tolist() == [[_ptrs(f.x_sorted), _ptrs(f.adiag), 0,
                                  1 << LEVELS, N >> LEVELS]]
    assert aargs[1:] == (1,) + gargs[2:-1] + (0,)
    if budget is None:
        assert [r[2].data_ptr() for r in grows] == [
            _ptrs(c) for c in f.sigma_cho]
    bm = build_ops.cross_rows(2 * (N >> LEVELS), RANK, 8,
                              stage="build_cross_levels")
    assert cargs[1:] == (LEVELS, RANK, D, bm,
                         _build.EPILOGUE_KIND["gaussian"], 1.0)
    assert ctable[:, 4:].tolist() == [[1 << (LEVELS - 1), 2 * (N >> LEVELS)]] \
        + [[1 << (lvl - 1), 2 * RANK] for lvl in range(1, LEVELS)]
    assert ctable[:, 0].tolist() == [_ptrs(f.x_sorted)] + [
        _ptrs(f.landmarks[lvl]) for lvl in range(1, LEVELS)]
    assert ctable[:, 1].tolist() == [_ptrs(f.landmarks[-1])] + [
        _ptrs(f.landmarks[lvl]) for lvl in range(LEVELS - 1)]
    linvs = [r[2] for r in crows]
    if budget is None:
        assert not masked and f.rank_mask is None
        assert ctable[:, 3].tolist() == [_ptrs(f.u)] + [_ptrs(w)
                                                        for w in f.w]
    else:
        (li,) = masked
        assert f.rank_mask is not None
        assert all(torch.equal(t, w) for t, w in zip(
            linvs, [li[-1]] + li[:-1]))
        full = hck.sigma_linv(_factor(RANK))
        assert not all(torch.equal(t, full.expand_as(t)) for t in linvs)


def test_leaf_stage_factors_is_two_one_group_launches(fake_card):
    """The update's leaf stage (grown leaves of 20 points, per-leaf
    parents): one gram_chol_levels launch of one group without a factor,
    one cross_solve_levels launch of one group, counted on the one-group
    wrappers."""
    rng = np.random.default_rng(4)
    blocks = torch.from_numpy(_points(rng, (6, 20), d=D)).float()
    lm = torch.from_numpy(_points(rng, (6, RANK), d=D)).float()
    linv = torch.eye(RANK).expand(6, RANK, RANK).contiguous()
    adiag, u = hck.leaf_stage_factors(blocks, lm, linv,
                                      BaseKernel("imq", 0.7, 1e-4))
    assert [c[1] for c in fake_card] == ["gram_chol_levels_f32",
                                         "cross_solve_levels_f32"]
    (_, _, gargs, _), (_, _, cargs, _) = fake_card
    assert gargs[0].tolist() == [[_ptrs(blocks), _ptrs(adiag), 0, 6, 20]]
    assert gargs[1:] == (1, D, _build.EPILOGUE_KIND["imq"], 0.7, 1e-4, 0)
    assert cargs[0].tolist() == [[_ptrs(blocks), _ptrs(lm), _ptrs(linv),
                                  _ptrs(u), 6, 20]]
    assert cargs[1:] == (1, RANK, D, _build.EPILOGUE_KIND["imq"], 0.7)
    assert build_ops.build_gram.launches == build_ops.build_cross.launches == 1
    assert build_ops.build_gram_levels.launches == 0
    assert build_ops.build_cross_levels.launches == 0


def test_oversized_tiles_raise_before_any_launch(fake_card):
    """A factored tile past the panel form's m 512 or a rank past its 256
    raises before anything launches; m 235 and 163 launch the resident
    kernel, m 236 and 164 (past its shared memory) the panel kernel, rank
    129 the panel cross kernel, and a launch without factors needs no tile
    at all."""
    f32, f64 = dict(dtype=torch.float32), dict(dtype=torch.float64)
    for o in (f32, f64):
        with pytest.raises(ValueError, match="above m = 512.*panel form"):
            build_ops.build_gram_levels([torch.zeros((1, 8, 3), **o),
                                         torch.zeros((1, 513, 3), **o)])
    with pytest.raises(ValueError, match="above 256.*panel form"):
        build_ops.build_cross_levels([torch.zeros((1, 8, 3))],
                                     [torch.zeros((1, 257, 3))],
                                     [torch.zeros((1, 257, 257))])
    with pytest.raises(ValueError, match="one r and one d"):
        build_ops.build_cross_levels(
            [torch.zeros((1, 8, 3)), torch.zeros((1, 8, 4))],
            [torch.zeros((1, 4, 3)), torch.zeros((1, 4, 4))],
            [torch.zeros((1, 4, 4))] * 2)
    with pytest.raises(ValueError, match="one d"):
        build_ops.build_gram_levels([torch.zeros((1, 8, 3)),
                                     torch.zeros((1, 8, 4))])
    with pytest.raises(ValueError, match="one launch takes"):
        build_ops.build_gram_levels(
            [torch.zeros((1, 4, 3))] * (build_ops.MAX_GROUPS + 1))
    assert fake_card == []
    build_ops.build_gram_levels([torch.zeros((1, 235, 3), **f32)])
    build_ops.build_gram_levels([torch.zeros((1, 163, 3), **f64)])
    build_ops.build_gram(torch.zeros((2, 400, 3)), want_chol=False)
    assert len(fake_card) == 3
    assert fake_card[-1][2][0][0, 2] == 0      # no factor pointer
    assert fake_card[-1][2][-1] == 0           # want_chol off
    # past the resident kernel's shared memory: one launch a form
    build_ops.build_gram_levels([torch.zeros((1, 8, 3), **f32),
                                 torch.zeros((1, 236, 3), **f32)])
    build_ops.build_gram_levels([torch.zeros((1, 164, 3), **f64)])
    build_ops.build_cross_levels([torch.zeros((1, 8, 3))],
                                 [torch.zeros((1, 129, 3))],
                                 [torch.zeros((1, 129, 129))])
    assert [c[1] for c in fake_card[3:]] == [
        "gram_chol_levels_f32", "gram_chol_levels_panel_f32",
        "gram_chol_levels_panel_f64", "cross_solve_levels_panel_f32"]
    assert [c[2][0][:, -1].tolist() for c in fake_card[3:]] == [
        [8], [236], [164], [8]]
