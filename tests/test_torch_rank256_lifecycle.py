"""The rank-256 lifecycle: the bfloat16-data entries of the panel forms (B1,
B2, B8, B9) and the leaf kernels' forms for leaves past 256 rows (B4's wide
instance, B5's chunks, B13's panel form), which ``model.update`` reaches
at leaf 256.

Parity (float64, the reference's draws injected as in test_torch_update):
``model.update`` at rank and leaf 256 (n 2,048, d 5, 3 levels) with
refresh "inverse" and "exact" against the reference's
``fit_incremental`` (xla), to 1e-10 relative; and a bf16 rank-256 fit of
each package against its own f64 fit on the same tree and landmarks,
within the reference's documented bf16 bounds (Gram-family factors 2e-2,
predictions 5e-2: src/repro/kernels/registry.py).  The wrappers: with a
recording launch (``card``) bf16 data at rank 256 take the panel forms'
bf16 entries and still raise past r 256 and m 512, and the leaf kernels
take leaves of 256 + k on their new forms.  The planners: every shape up
to n0 512 and r 256 gets launches whose blocks fit the shared memory.  The
kernels themselves run only on the card (chip_smoke.py phase 3r).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws
from test_torch_update import insert_draws

from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch.core import krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build
from repro_torch.kernels.build_stage import ops as build_ops
from repro_torch.kernels.hck_leaf import ops as leaf_ops
from repro_torch.kernels.registry import SolveConfig
from repro_torch.kernels.update_stage import ops as update_ops

D, RANK, LEVELS = 5, 256, 3
# test_torch_rank256's settings: at jitter 1e-8 U (kappa(Sigma)-amplified,
# as the reference's registry notes) differs between the two frameworks'
# orders of summation by 5.6e-10 relative after an update at rank 256
SIGMA, JITTER, LAM = 1.5, 1e-3, 1e-2
# jitter 1e-4 as the reference launcher's bf16 convention; at leaves of
# 256 the inversion of the reference's bf16 factors (its xla lane rounds
# them to bf16: ROADMAP C17) needs a ridge of n0 eps_bf16 = 256 / 2^8
# (registry.py's note): NaN at the launcher's lambda 1e-1
BF16_JITTER, BF16_LAM, BF16_FLOOR = 1e-4, 1e-1, 1.0
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
XLA = JSolveConfig(backend="xla")


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _target(x):
    return np.sin(x[:, 0]) + 0.25 * np.cos(2.0 * x[:, 1])


def _fit_pair(x, y, *, jitter, lam, prec=None):
    """The reference's krr.fit (xla, key 1) and the port's on its
    directions and landmark rows, both at rank and leaf 256."""
    key = jax.random.PRNGKey(1)
    jm = jkrr.fit(jnp.asarray(x), jnp.asarray(y),
                  kernel=JKernel("gaussian", SIGMA, jitter), lam=lam,
                  rank=RANK, levels=x.shape[0].bit_length() - 9, key=key,
                  solve_config=JSolveConfig(backend="xla", precision=prec))
    _, kbuild = jax.random.split(key)
    m = krr.fit(x, y, kernel=BaseKernel("gaussian", SIGMA, jitter), lam=lam,
                rank=RANK, levels=jm.factors.levels, device="cpu",
                solve_config=SolveConfig(precision=prec),
                directions=[_t(v) for v in jm.factors.tree.directions],
                landmark_index=landmark_draws(kbuild, x.shape[0],
                                              jm.factors.levels, RANK))
    assert m.factors.leaf_size == jm.factors.leaf_size == RANK
    return jm, m


@pytest.fixture(scope="module")
def base(f64):
    """n 2,048 (8 leaves of 256), the reference's model and the port's on
    its draws, and 48 queries."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2048, D))
    jm, m = _fit_pair(x, _target(x), jitter=JITTER, lam=LAM)
    return jm, m, rng.standard_normal((48, D))


# ---------------------------------------------------------------------------
# model.update at rank and leaf 256 against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("refresh", ["inverse", "exact"])
def test_update_at_leaf_256_matches_reference(base, refresh):
    """An insert of 96 points grows the leaves to 256 + k (k the batch's
    largest per-leaf count), the shapes B4's wide instance, B5 and B13's
    panel form take on the card; a second round borders the grown leaves
    again.  Factors, alpha and predictions to 1e-10 relative."""
    jm, m, q = base
    for seed, count in ((11, 96), (12, 40)):
        xn = np.random.default_rng(seed).standard_normal((count, D))
        key = jax.random.PRNGKey(seed)
        jm, jinfo = jkrr.fit_incremental(jm, jnp.asarray(xn),
                                         jnp.asarray(_target(xn)),
                                         refresh=refresh, key=key)
        m, info = m.update(xn, _target(xn), refresh=refresh,
                           **insert_draws(key, m.factors.num_leaves,
                                          jinfo.record.k,
                                          m.factors.leaf_size))
        assert info.record.k == jinfo.record.k > 0
        assert info.converged and m.factors.leaf_size > RANK
        np.testing.assert_array_equal(m.factors.tree.perm.numpy(),
                                      np.asarray(jm.factors.tree.perm))
        for field in ("x_sorted", "u", "adiag"):
            assert _rel_max(getattr(m.factors, field),
                            getattr(jm.factors, field)) <= 1e-10, field
        assert _rel_max(m.alpha, jm.alpha) <= 1e-10
        assert _rel_max(m.predict(_t(q)), jm.predict(jnp.asarray(q))) <= 1e-10
        if refresh == "inverse":
            assert _rel_max(m.leaf_lo, jm.leaf_lo) <= 1e-10


def test_bf16_fit_at_rank_256_within_bounds(f64):
    """Each package's bf16 fit at rank and leaf 256 (n 1,024, jitter 1e-4)
    against its own f64 fit of the same settings: the Gram-family factors
    within 2e-2 and the predictions within 5e-2 (relative norms), the
    reference's documented bf16 bounds, at lambda 1 (the reference's bf16
    ridge floor at n0 256); the port's also at the launcher's lambda 1e-1,
    where the reference's inversion gives NaN."""
    rng = np.random.default_rng(32)
    x = rng.standard_normal((1024, D))
    q = rng.standard_normal((64, D))

    fits = {p: _fit_pair(x, _target(x), jitter=BF16_JITTER, lam=BF16_FLOOR,
                         prec=p) for p in (None, "bf16")}
    for pkg, qq in ((0, jnp.asarray(q)), (1, _t(q))):
        ref, got = fits[None][pkg], fits["bf16"][pkg]
        fam = [(a, b) for fld in ("sigma", "sigma_cho")
               for a, b in zip(getattr(got.factors, fld),
                               getattr(ref.factors, fld))]
        fam.append((got.factors.adiag, ref.factors.adiag))
        assert max(_rel_norm(a, b) for a, b in fam) <= 2e-2
        assert _rel_norm(got.predict(qq), ref.predict(qq)) <= 5e-2
    assert fits["bf16"][1].factors.u.dtype == F32
    # the port's at the launcher's lambda 1e-1 (its bf16 factors carry the
    # data's rounding alone), on one tree and landmark set
    got, ref = (krr.fit(x, _target(x), kernel=BaseKernel(
        "gaussian", SIGMA, BF16_JITTER), lam=BF16_LAM, rank=RANK,
        device="cpu", solve_config=SolveConfig(precision=p),
        generator=torch.Generator().manual_seed(3)) for p in ("bf16", None))
    assert _rel_norm(got.predict(_t(q)), ref.predict(_t(q))) <= 5e-2


# ---------------------------------------------------------------------------
# The wrappers' choice of form and entry, with a recording launch
# ---------------------------------------------------------------------------

BUILD_WRAPPERS = (build_ops.build_gram, build_ops.build_gram_levels,
                  build_ops.build_cross, build_ops.build_cross_levels,
                  build_ops.build_gram_dist, build_ops.build_gram_dist_levels,
                  build_ops.build_cross_dist,
                  build_ops.build_cross_dist_levels)


@pytest.fixture
def card(monkeypatch):
    """Send CPU tensors down the wrappers' card path: the device check
    passes them and the launch records (library, symbol, args); every
    counter of the wrappers here starts at 0."""
    calls = []
    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, dev, *args:
                        calls.append((name, symbol, args)))
    for fn in BUILD_WRAPPERS:
        for attr in ("launches", "panel_launches", "bf16_launches"):
            monkeypatch.setattr(fn, attr, 0)
    for fn, attrs in ((leaf_ops.leaf_solve, ("launches", "wide_launches")),
                      (leaf_ops.leaf_matvec, ("launches",)),
                      (update_ops.leaf_update, ("launches",
                                                "panel_launches"))):
        for attr in attrs:
            monkeypatch.setattr(fn, attr, 0)
    monkeypatch.setattr(leaf_ops.leaf_matvec, "shapes",
                        type(leaf_ops.leaf_matvec.shapes)())
    return calls


def _bf16(*shape):
    return torch.zeros(shape, dtype=BF16)


def test_bf16_gram_at_rank_256_takes_the_panel_bf16_entries(card):
    """B1: a grouped launch over levels of m 24 and 256 with bf16 points is
    two launches, the resident and the panel form's bf16 entries; the
    leaves' Adiag (no factor) stays on the resident bf16 entry; every
    output float32."""
    out = build_ops.build_gram_levels([_bf16(2, 24, 3), _bf16(1, 256, 3)])
    assert [o.dtype for pair in out for o in pair] == [F32] * 4
    (rl, rs, ra), (pl, ps, pa) = card
    assert (rl, rs) == ("build_stage_bf16", "gram_chol_levels_bf16")
    assert (pl, ps) == ("build_stage_panel_bf16",
                        "gram_chol_levels_panel_bf16")
    assert ra[0][:, -1].tolist() == [24] and pa[0][:, -1].tolist() == [256]
    fn = build_ops.build_gram_levels
    assert (fn.launches, fn.panel_launches, fn.bf16_launches) == (2, 1, 2)
    gram, chol = build_ops.build_gram(_bf16(2, 256, 3), want_chol=False)
    assert chol is None and gram.dtype == F32
    assert card[-1][:2] == ("build_stage_bf16", "gram_chol_levels_bf16")
    assert build_ops.build_gram.bf16_launches == 1
    assert build_ops.build_gram.panel_launches == 0


def test_bf16_gram_dist_at_rank_256_takes_the_panel_bf16_entries(card):
    """B8: bf16 Sigma tiles of 256 on the panel form's bf16 entry, the
    leaves' gram_dist (no factor) on its resident bf16 entry."""
    (gram, chol), = build_ops.build_gram_dist_levels([_bf16(2, 256, 256)])
    assert gram.dtype == chol.dtype == F32
    assert card[-1][:2] == ("build_dist_panel_bf16",
                            "gram_chol_dist_levels_panel_bf16")
    gram, _ = build_ops.build_gram_dist(_bf16(2, 256, 256), want_chol=False)
    assert card[-1][:2] == ("build_dist_bf16", "gram_dist_bf16")
    for fn, panel in ((build_ops.build_gram_dist_levels, 1),
                      (build_ops.build_gram_dist, 0)):
        assert (fn.launches, fn.panel_launches, fn.bf16_launches) == (
            1, panel, 1)


@pytest.mark.parametrize("dist", [False, True], ids=["B2", "B9"])
@pytest.mark.parametrize("r", [129, 200, 256])
def test_bf16_cross_past_rank_128_takes_the_panel_bf16_entry(card, dist, r):
    """B2 and B9: bf16 data with float32 Linv past rank 128 on the panel
    form's bf16 entry (one launch for U and the W levels), U float32."""
    ms = (48, 130, 512)
    li = [torch.zeros((2, r, r)) for _ in ms]
    if dist:
        fn, lib = build_ops.build_cross_dist_levels, "build_dist_panel_bf16"
        sym = "cross_solve_dist_levels_panel_bf16"
        us = fn([_bf16(2, m, r) for m in ms], li)
    else:
        fn, lib = build_ops.build_cross_levels, "build_stage_panel_bf16"
        sym = "cross_solve_levels_panel_bf16"
        us = fn([_bf16(2, m, 3) for m in ms], [_bf16(2, r, 3) for _ in ms],
                li)
    assert [u.dtype for u in us] == [F32] * 3
    (name, symbol, args), = card
    assert (name, symbol) == (lib, sym) and args[1:3] == (3, r)
    assert (fn.launches, fn.panel_launches, fn.bf16_launches) == (1, 1, 1)


def test_bf16_routes_still_raise_past_their_limits(card):
    """bf16 data past r 256 or past m 512 raise naming the panel form's
    limit, before any launch, as float32 data do."""
    with pytest.raises(ValueError, match="r=257 is above 256.*panel form"):
        build_ops.build_cross_levels([_bf16(1, 48, 3)], [_bf16(1, 257, 3)],
                                     [torch.zeros((1, 257, 257))])
    with pytest.raises(ValueError, match="r=257 is above 256.*panel form"):
        build_ops.build_cross_dist_levels([_bf16(1, 48, 257)],
                                          [torch.zeros((1, 257, 257))])
    with pytest.raises(ValueError, match="above m = 512.*panel form"):
        build_ops.build_gram_levels([_bf16(1, 24, 3), _bf16(1, 513, 3)])
    with pytest.raises(ValueError, match="above m = 512.*panel form"):
        build_ops.build_gram_dist_levels([_bf16(1, 513, 513)])
    assert card == []


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [7, 19])
def test_b4_takes_grown_leaves_on_its_wide_instance(card, dtype, k):
    """B4 at a leaf of 256 + k, rank 256 (a model.update at leaf 256): the
    kernel's wide instance (four quads of x a lane), Linv and U read in
    place; leaves of 256 keep the resident instance, past 512 rows it
    raises."""
    n0, z = RANK + k, lambda *s: torch.zeros(s, dtype=dtype)
    args = (z(4, n0, n0), z(4, n0, RANK), z(2, RANK, RANK), z(4, n0, 7))
    x, c = leaf_ops.leaf_solve(*args)
    assert x.shape == (4, n0, 7) and c.shape == (4, RANK, 7)
    plan = leaf_ops.solve_plan(n0, RANK, 7, x.element_size())
    assert plan["mq"] == 4 and not plan["stage_l"] and not plan["stage_u"]
    name, symbol, largs = card[-1]
    assert (name, symbol) == ("leaf_solve", f"leaf_solve_{_build.SUFFIX[dtype]}")
    assert largs[6:13] == (4, n0, RANK, 7, 1, 0, 0)
    leaf_ops.leaf_solve(z(4, RANK, RANK), z(4, RANK, RANK), z(2, RANK, RANK),
                        z(4, RANK, 7))
    assert leaf_ops.solve_plan(RANK, RANK, 7, x.element_size())["mq"] == 2
    assert (leaf_ops.leaf_solve.launches,
            leaf_ops.leaf_solve.wide_launches) == (2, 1)
    with pytest.raises(ValueError, match="512 rows and rank 256"):
        leaf_ops.leaf_solve(z(1, 513, 513), z(1, 513, 8), z(1, 8, 8),
                            z(1, 513, 1))
    with pytest.raises(ValueError, match="512 rows and rank 256"):
        leaf_ops.leaf_solve(z(1, 16, 16), z(1, 16, 257), z(1, 257, 257),
                            z(1, 16, 1))


@pytest.mark.parametrize("dtype,n0,k,form", [
    (F64, 256, 8, "resident"), (F64, 256, 9, "panel"),
    (F64, 274, 5, "resident"), (F64, 274, 6, "panel"),
    (F32, 256, 32, "resident"), (F32, 256, 33, "panel"),
    (F32, 292, 24, "resident"), (F32, 292, 25, "panel"),
    (F64, 1, 511, "panel")], ids=str)
def test_b13_takes_grown_borders_on_its_panel_form(card, dtype, n0, k, form):
    """B13 keeps its resident form while the resident plan fits (ISSUE's
    table of the largest k: f64 8 at n0 256, 5 at 274; f32 32 at 256, 24
    at 292) and takes the panel form past it, with a (P, 2, k, k) scratch;
    past n0 + k = 512 it raises before any launch."""
    z = lambda *s: torch.zeros(s, dtype=dtype)
    lo_ext, li_ext = update_ops.leaf_update(z(3, n0, n0), z(3, n0, n0),
                                            z(3, k, n0), z(3, k, k))
    assert lo_ext.shape == li_ext.shape == (3, n0 + k, n0 + k)
    (name, symbol, args), = card
    sfx = _build.SUFFIX[dtype]
    if form == "panel":
        assert (name, symbol) == ("leaf_update_panel",
                                  f"leaf_update_panel_{sfx}")
        assert args[6].shape == (3, 2, k, k) and args[7:] == (3, n0, k)
    else:
        assert (name, symbol) == ("leaf_update", f"leaf_update_{sfx}")
    assert update_ops.leaf_update.launches == 1
    assert update_ops.leaf_update.panel_launches == (form == "panel")
    with pytest.raises(ValueError, match="n0 \\+ k = 512.*panel form"):
        update_ops.leaf_update(z(1, 300, 300), z(1, 300, 300),
                               z(1, 213, 300), z(1, 213, 213))
    assert len(card) == 1


@pytest.mark.parametrize("n0,k,widths", [
    (299, 8, [8]), (300, 8, [7, 1]), (300, 7, [7]), (309, 13, [6, 6, 1]),
    (400, 7, [1] * 7), (512, 3, [1] * 3), (512, 1, [1])])
def test_b5_takes_grown_leaves_in_chunks(card, n0, k, widths):
    """B5 in float64 at r 256 past n0 299: b in chunks of the most columns
    a launch's plan fits (a tile of 8, then below 8, down to the KT = 1
    instance), every launch within the shared memory."""
    z = lambda *s: torch.zeros(s, dtype=F64)
    y, c = leaf_ops.leaf_matvec(z(2, n0, n0), z(2, n0, RANK), z(2, n0, k))
    assert y.shape == (2, n0, k) and c.shape == (2, RANK, k)
    assert [args[8] for _, _, args in card] == widths
    assert all(args[-1] <= _build.SMEM_MAX for _, _, args in card)
    assert leaf_ops.leaf_matvec.launches == len(widths)


# ---------------------------------------------------------------------------
# The planners: every shape up to n0 512 and r 256 fits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n0", [1, 17, 128, 255, 256, 257, 299, 300, 384,
                                511, 512])
@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_grown_leaf_plans_fit_shared_memory(itemsize, n0):
    """B4 (one plan for any k: a group of 8 columns at a time), B5 (one
    launch, or chunks of matvec_max_rhs columns and the rest) and B13 (for
    n0 + k <= 512, its resident plan or its panel form's block) within
    _build.SMEM_MAX at every r and k of the grid."""
    for r in (1, 16, 64, 128, 129, 200, 256):
        assert leaf_ops.solve_plan(n0, r, 7, itemsize)["smem"] \
            <= _build.SMEM_MAX
        w = leaf_ops.matvec_max_rhs(n0, r, itemsize)
        for k in (1, 2, 7, 8, 9, 12, 16, 33, 64, 200):
            plan = leaf_ops.matvec_plan(n0, r, k, itemsize)["smem"]
            if plan > _build.SMEM_MAX:
                assert k > w >= 1
                for part in {w, k % w or w}:
                    assert leaf_ops.matvec_plan(
                        n0, r, part, itemsize)["smem"] <= _build.SMEM_MAX
    for k in (1, 2, 7, 8, 9, 16, 25, 33, 64, 128, 256, 511):
        if n0 + k > leaf_ops.PANEL_MAX_M:
            continue
        route = update_ops.update_route("t", n0, k, itemsize)
        smem = (update_ops.update_plan(n0, k, itemsize)["smem"]
                if route == "resident"
                else update_ops.update_panel_smem(n0, k, itemsize))
        assert smem <= _build.SMEM_MAX, (n0, k, route)
