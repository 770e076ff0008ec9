"""The sweep's grouped kernels: B8 ``gram_chol_dist_levels`` (every Sigma
level of one sigma in one launch, factored by B3's blocked routine) and B9
``cross_solve_dist_levels`` (U and every W level in one launch; float32 in
split TF32 on the tensor cores), both in ``csrc/build_dist.cu``.

No card is needed.  The kernels' arithmetic is emulated on the CPU: B8 as
B3's blocked factor (``blocked_factor`` of
``test_torch_leaf_policy_redesign.py``) on kappa_sigma(D) + jitter m I;
B9 in float64 from TF32 operands split as ``csrc/tf32x3.cuh`` splits them
(three passes lo hi + hi lo + hi hi, and one pass hi hi as the control),
summed in the kernel's order with Linv's zero triangle skipped by 8-column
k-step, a float32 rounding after each pass.  Both are held against the
reference's Pallas kernels in interpret mode and the port's plain
versions.  The grouped wrappers' card path is followed with the launch
replaced by a recorder (one launch per call, its table of groups), and the
grouped plain versions equal the per-level ones bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_leaf_policy_redesign import blocked_factor
from test_torch_tc_split import _split_reg

from repro.kernels.build_stage import ops as jbuild_ops
from repro_torch.core import hck
from repro_torch.core.kernels_fn import BaseKernel, kernel_epilogue
from repro_torch.kernels import _build, registry
from repro_torch.kernels.build_stage import ops as build_ops
from repro_torch.kernels.build_stage.ref import (build_cross_dist_levels_ref,
                                                 build_cross_dist_ref,
                                                 build_gram_dist_levels_ref,
                                                 build_gram_dist_ref,
                                                 direct_dist)

KERNELS = ["gaussian", "imq", "laplace"]
METRIC = {"gaussian": "l2", "imq": "l2", "laplace": "l1"}


def _points(rng, shape, d=54):
    """make_data's distribution: N(0, (2/d) I)."""
    return rng.standard_normal(shape + (d,)) * np.sqrt(2.0 / d)


def _self_dist(rng, p, m, metric="l2", d=54):
    x = torch.from_numpy(_points(rng, (p, m), d))
    return direct_dist(x, x, metric).numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# (a) B8: B3's blocked factor on the Gram of the cached distances
# ---------------------------------------------------------------------------

def _b8_emulated(dist, name, sigma, jitter):
    """The grouped kernel's output: the Gram (the epilogue, jitter m on the
    diagonal, in the tile's dtype) and its blocked factor."""
    gram = build_gram_dist_ref(torch.from_numpy(dist), name=name,
                               sigma=sigma, jitter=jitter,
                               want_chol=False)[0]
    return gram, blocked_factor(gram)[0]


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("m", [16, 128])
def test_b8_blocked_emulation_f32(name, m):
    """f32: the blocked factor within 1e-4 relative of the reference's
    gram_chol_dist kernel (interpret mode) and of the plain version (the
    gate of chip_smoke.py's phase 8)."""
    dist = _self_dist(np.random.default_rng(m), 3, m,
                      METRIC[name]).astype(np.float32)
    opts = dict(name=name, sigma=1.0, jitter=1e-3)
    gram, lo = _b8_emulated(dist, **opts)
    jg, jl = jbuild_ops.build_gram_dist(jnp.asarray(dist), want_chol=True,
                                        interpret=True, **opts)
    assert jl.dtype == jnp.float32
    pg, pl = build_gram_dist_ref(torch.from_numpy(dist), **opts)
    assert _rel(gram, jg) <= 1e-6 and _rel(gram, pg) == 0.0
    assert lo.dtype == torch.float32 and not lo.triu(1).any()
    assert _rel(lo, jl) <= 1e-4, _rel(lo, jl)
    assert _rel(lo, pl) <= 1e-4, _rel(lo, pl)


@pytest.mark.parametrize("m", [16, 128])
def test_b8_blocked_emulation_f64(f64, m):
    dist = _self_dist(np.random.default_rng(m + 1), 2, m)
    opts = dict(name="gaussian", sigma=1.0, jitter=1e-5)
    _, lo = _b8_emulated(dist, **opts)
    _, jl = jbuild_ops.build_gram_dist(jnp.asarray(dist), want_chol=True,
                                       interpret=True, **opts)
    _, pl = build_gram_dist_ref(torch.from_numpy(dist), **opts)
    assert lo.dtype == torch.float64
    assert _rel(lo, jl) <= 1e-10 and _rel(lo, pl) <= 1e-10


def test_b8_indefinite_tile_gives_nan():
    """A duplicated point and a negative jitter make the second tile
    indefinite: the blocked factor gives NaN there (no pivot clamp), as
    the reference and the plain version do; the first tile stays finite."""
    rng = np.random.default_rng(5)
    x = _points(rng, (2, 16), d=5)
    x[1, 7] = x[1, 2]
    t = torch.from_numpy(x.astype(np.float32))
    dist = direct_dist(t, t, "l2").numpy()
    opts = dict(name="gaussian", sigma=0.1, jitter=-1e-3)
    _, lo = _b8_emulated(dist, **opts)
    _, jl = jbuild_ops.build_gram_dist(jnp.asarray(dist), want_chol=True,
                                       interpret=True, **opts)
    _, pl = build_gram_dist_ref(torch.from_numpy(dist), **opts)
    for chol in (lo, torch.from_numpy(np.array(jl)), pl):
        assert bool(torch.isfinite(chol[0]).all())
        assert bool(torch.isnan(chol[1]).any())


# ---------------------------------------------------------------------------
# (b) B9: split TF32 on the tensor cores, emulated in float64
# ---------------------------------------------------------------------------

def _acc(acc, term):
    """One product added to the float32 accumulator."""
    return (acc + term).astype(np.float32).astype(np.float64)


def _b9_emulated(dist, linv, name, sigma, passes):
    """B9's tensor-core kernel: K = kappa(D) in float32; Y = K Linv^T by
    k-steps of 8 columns, tile j of Y taking k-steps kk <= j only; U = Y
    Linv with Y's float32 accumulator split again, tile jc of U taking
    k-steps ks >= jc only.  Three passes lo hi + hi lo + hi hi (or one, hi
    hi), each added to the float32 accumulator in that order.  Within a
    k-step the tensor core's 8-term sum is exact here (its order, KEY_OF's
    for the second product, does not matter in float64).  Linv and K are
    zero-padded to the kernel's tiles (csrc/build_dist.cu tc::tiles)."""
    b, m, r = dist.shape
    nt = 4 * -(-r // 32)
    rp = 8 * nt
    k = kernel_epilogue(name, sigma)(torch.from_numpy(dist)).numpy()
    kp = np.zeros((b, m, rp))
    kp[:, :, :r] = k
    lp = np.zeros((b, rp, rp))
    lp[:, :r, :r] = linv
    kh, kl = _split_reg(kp)
    lh, ll = _split_reg(lp)
    blk = lambda a, i, j: a[:, 8 * i:8 * i + 8, 8 * j:8 * j + 8]
    col = lambda a, j: a[:, :, 8 * j:8 * j + 8]

    def terms(ah, al, bh, bl):
        return [ah @ bh] if passes == 1 else [al @ bh, ah @ bl, ah @ bh]

    y = np.zeros((b, m, rp))
    for kk in range(nt):
        for j in range(kk, nt):
            # Y[:, j] += K[:, kk] Linv[j, kk]^T
            for t in terms(col(kh, kk), col(kl, kk),
                           np.swapaxes(blk(lh, j, kk), 1, 2),
                           np.swapaxes(blk(ll, j, kk), 1, 2)):
                y[:, :, 8 * j:8 * j + 8] = _acc(col(y, j), t)
    yh, yl = _split_reg(y)
    u = np.zeros((b, m, rp))
    for ks in range(nt):
        for jc in range(ks + 1):
            # U[:, jc] += Y[:, ks] Linv[ks, jc]
            for t in terms(col(yh, ks), col(yl, ks), blk(lh, ks, jc),
                           blk(ll, ks, jc)):
                u[:, :, 8 * jc:8 * jc + 8] = _acc(col(u, jc), t)
    return u[:, :, :r]


def _sigma_linv(rng, b, r, jitter=1e-5):
    """Parents' Linv at the sweep's distribution: the inverse Cholesky
    factor of kappa(Sigma) + jitter r I over r landmarks in 54 features,
    in float64."""
    z = torch.from_numpy(_points(rng, (b, r)))
    gram = torch.exp(-0.5 * direct_dist(z, z, "l2")) + jitter * r * torch.eye(
        r, dtype=torch.float64)
    return hck.sigma_linv(torch.linalg.cholesky(gram)).numpy()


@pytest.mark.parametrize("b, m, r", [(2, 256, 128), (3, 40, 12)],
                         ids=["covtype", "ragged"])
def test_b9_split_tf32_meets_the_gate(f64, b, m, r):
    """Three passes within chip_smoke.py's componentwise gate, |dU| <=
    4 (2r + 1) eps32 |K||Linv^T||Linv|, of the reference's
    cross_solve_dist kernel (interpret mode) in float64; one pass, the
    control, fails it.  The plain version in f32 meets the gate too."""
    rng = np.random.default_rng(r)
    lm = torch.from_numpy(_points(rng, (b, r)))
    pts = torch.from_numpy(_points(rng, (b, m)))
    dist = direct_dist(pts, lm, "l2").numpy().astype(np.float32)
    linv = _sigma_linv(rng, b, r).astype(np.float32)
    want = np.asarray(jbuild_ops.build_cross_dist(
        jnp.asarray(dist, jnp.float64), jnp.asarray(linv, jnp.float64),
        sigma=1.0, interpret=True))
    assert want.dtype == np.float64
    kabs = np.abs(kernel_epilogue("gaussian", 1.0)(
        torch.from_numpy(dist.astype(np.float64))).numpy())
    gate = (4 * (2 * r + 1) * np.finfo(np.float32).eps
            * ((kabs @ np.abs(np.swapaxes(linv, 1, 2))) @ np.abs(linv)))
    three = np.abs(_b9_emulated(dist, linv, "gaussian", 1.0, 3) - want)
    one = np.abs(_b9_emulated(dist, linv, "gaussian", 1.0, 1) - want)
    plain = np.abs(build_cross_dist_ref(
        torch.from_numpy(dist), torch.from_numpy(linv)).double().numpy()
        - want)
    print(f"B9 emulated (b {b}, m {m}, r {r}), max |dU| / gate: three "
          f"passes {(three / gate).max():.3e}, one pass "
          f"{(one / gate).max():.3e}, plain f32 {(plain / gate).max():.3e}")
    assert (three / gate).max() <= 1.0
    assert (plain / gate).max() <= 1.0
    assert (one / gate).max() > 1.0


@pytest.mark.parametrize("name", KERNELS)
def test_b9_emulation_matches_the_plain_version(name):
    """Every base kernel: the emulated kernel within 1e-5 of the largest
    entry of the port's plain version and of the reference's kernel
    (interpret mode), both in float32."""
    rng = np.random.default_rng(11)
    lm = torch.from_numpy(_points(rng, (2, 16), d=5))
    pts = torch.from_numpy(_points(rng, (2, 48), d=5))
    dist = direct_dist(pts, lm, METRIC[name]).numpy().astype(np.float32)
    linv = _sigma_linv(rng, 2, 16, jitter=1e-2).astype(np.float32)
    got = _b9_emulated(dist, linv, name, 0.9, 3)
    plain = build_cross_dist_ref(torch.from_numpy(dist),
                                 torch.from_numpy(linv), name=name,
                                 sigma=0.9)
    ref = jbuild_ops.build_cross_dist(jnp.asarray(dist), jnp.asarray(linv),
                                      name=name, sigma=0.9, interpret=True)
    assert _rel(got, plain) <= 1e-5 and _rel(got, ref) <= 1e-5


# ---------------------------------------------------------------------------
# (c) The grouped wrappers' card path, the launch recorded
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrappers' card path: the device check
    passes them and the launch records (library, symbol, args)."""
    calls = []
    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, dev, *args:
                        calls.append((name, symbol, args)))
    for fn in (build_ops.build_gram_dist, build_ops.build_cross_dist,
               build_ops.build_gram_dist_levels,
               build_ops.build_cross_dist_levels):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


def _ptrs(*ts):
    return [t.data_ptr() for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_grouped_gram_one_launch_and_its_table(fake_card, dtype):
    """Ragged levels (1, 2 and 8 nodes, m 8 and 16) in one launch; the
    table rows are (dist, gram, chol, nodes, m) of each level."""
    dists = [torch.zeros((1, 8, 8), dtype=dtype),
             torch.zeros((2, 16, 16), dtype=dtype),
             torch.zeros((8, 16, 16), dtype=dtype)]
    out = build_ops.build_gram_dist_levels(dists, name="imq", sigma=0.5,
                                           jitter=1e-3)
    (lib, symbol, args), = fake_card
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert (lib, symbol) == ("build_dist", f"gram_chol_dist_levels_{sfx}")
    table = args[0]
    assert table.dtype == torch.int64 and table.device.type == "cpu"
    assert table.tolist() == [
        _ptrs(d, g, c) + [d.shape[0], d.shape[1]]
        for d, (g, c) in zip(dists, out)]
    assert args[1:] == (3, _build.EPILOGUE_KIND["imq"], 0.5, 1e-3)
    assert [tuple(g.shape) for g, _ in out] == [tuple(d.shape)
                                                for d in dists]
    assert build_ops.build_gram_dist_levels.launches == 1
    assert build_ops.build_gram_dist.launches == 0


@pytest.mark.parametrize("dtype, bm", [(torch.float32, None),
                                       (torch.float64, 64)],
                         ids=["f32", "f64"])
def test_grouped_cross_one_launch_and_its_table(fake_card, dtype, bm):
    """U with the leaves' m = 2 n0 = 40 (not 2r), W of level 1 (one
    node) and of level 2 with a rank-masked Linv (a tensor of its own,
    not beside the others): one launch; float64 passes the CUDA-core
    tile's height for the largest m, float32 none."""
    r = 12
    o = dict(dtype=dtype)
    linv = [torch.zeros((4, r, r), **o), torch.zeros((1, r, r), **o)]
    masked = torch.zeros((2, r, r), **o).clone()
    dists = [torch.zeros((4, 40, r), **o), torch.zeros((1, 2 * r, r), **o),
             torch.zeros((2, 2 * r, r), **o)]
    linvs = [linv[0], linv[1], masked]
    out = build_ops.build_cross_dist_levels(dists, linvs, name="laplace",
                                            sigma=2.0)
    (lib, symbol, args), = fake_card
    sfx = "f32" if dtype == torch.float32 else "f64"
    assert (lib, symbol) == ("build_dist", f"cross_solve_dist_levels_{sfx}")
    assert args[0].tolist() == [
        _ptrs(d, li, u) + [d.shape[0], d.shape[1]]
        for d, li, u in zip(dists, linvs, out)]
    tail = (3, r) + ((bm,) if bm else ()) + (
        _build.EPILOGUE_KIND["laplace"], 2.0)
    assert args[1:] == tail
    if bm:
        assert bm == build_ops.cross_rows(40, r, 8,
                                          smem=build_ops.cross_dist_smem)
    assert [tuple(u.shape) for u in out] == [tuple(d.shape) for d in dists]
    assert build_ops.build_cross_dist_levels.launches == 1
    assert build_ops.build_cross_dist.launches == 0


def test_grouped_launch_leaves_empty_levels_out(fake_card):
    """Levels of no node stay out of the table; a call whose levels are
    all empty launches nothing."""
    dists = [torch.zeros((1, 4, 4)), torch.zeros((0, 4, 4)),
             torch.zeros((2, 4, 4))]
    build_ops.build_gram_dist_levels(dists)
    (_, _, args), = fake_card
    assert args[1] == 2 and args[0][:, 3].tolist() == [1, 2]
    build_ops.build_gram_dist_levels([torch.zeros((0, 4, 4))])
    assert len(fake_card) == 1
    assert build_ops.build_gram_dist_levels.launches == 1


def test_grouped_checks_raise_before_any_launch(fake_card):
    with pytest.raises(ValueError, match="above 256.*panel form"):
        build_ops.build_cross_dist_levels([torch.zeros((1, 8, 257))],
                                          [torch.zeros((1, 257, 257))])
    with pytest.raises(ValueError, match="one r"):
        build_ops.build_cross_dist_levels(
            [torch.zeros((1, 8, 4)), torch.zeros((1, 8, 6))],
            [torch.zeros((1, 4, 4)), torch.zeros((1, 6, 6))])
    with pytest.raises(ValueError, match="above m = 512.*panel form"):
        build_ops.build_gram_dist_levels([torch.zeros((1, 513, 513))])
    with pytest.raises(ValueError, match="above m = 512.*panel form"):
        build_ops.build_gram_dist_levels(
            [torch.zeros((1, 513, 513), dtype=torch.float64)])
    build_ops.build_gram_dist_levels([torch.zeros((1, 240, 240))])
    with pytest.raises(ValueError, match="one launch takes"):
        build_ops.build_gram_dist_levels(
            [torch.zeros((1, 4, 4))] * (build_ops.MAX_GROUPS + 1))
    with pytest.raises(ValueError, match="unknown base kernel"):
        build_ops.build_gram_dist_levels([torch.zeros((1, 4, 4))],
                                         name="cauchy")
    assert len(fake_card) == 1
    # past the resident kernel's shared memory (m 241 in f32, 170 in f64)
    # the panel form launches
    build_ops.build_gram_dist_levels([torch.zeros((1, 241, 241))])
    build_ops.build_gram_dist_levels(
        [torch.zeros((1, 170, 170), dtype=torch.float64)])
    assert [c[1] for c in fake_card[1:]] == [
        "gram_chol_dist_levels_panel_f32", "gram_chol_dist_levels_panel_f64"]


def test_sweep_factors_launches_each_grouped_kernel_once(fake_card,
                                                         monkeypatch):
    """On the card's route, one sigma of sweep_factors is three launches:
    the grouped Sigma levels, the leaves' Adiag (gram_dist, no factor)
    and the grouped U and W levels; the table holds every level."""
    monkeypatch.setattr(hck, "resolve_backend",
                        lambda config, stage, *ts: "cuda")
    x = torch.from_numpy(_points(np.random.default_rng(3), (256,), d=3))
    plan = hck.build_sweep_plan(x, levels=4, rank=8, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    hck.sweep_factors(plan, BaseKernel("gaussian", 1.0, 1e-3))
    assert [c[1] for c in fake_card] == [
        "gram_chol_dist_levels_f64", "gram_dist_f64",
        "cross_solve_dist_levels_f64"]
    gram_table, cross_table = fake_card[0][2][0], fake_card[2][2][0]
    assert gram_table[:, 3:].tolist() == [[1 << lvl, 8] for lvl in range(4)]
    assert cross_table[:, 3:].tolist() == [[8, 32]] + [
        [1 << (lvl - 1), 16] for lvl in range(1, 4)]
    assert cross_table[0, 0] == plan.leaf_cross.data_ptr()
    assert build_ops.build_gram_dist_levels.launches == 1
    assert build_ops.build_cross_dist_levels.launches == 1
    assert build_ops.build_gram_dist.launches == 1
    assert build_ops.build_cross_dist.launches == 0


# ---------------------------------------------------------------------------
# (d) The grouped plain versions are the per-level ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_grouped_plain_versions_equal_per_level_bit_for_bit(name, dtype):
    rng = np.random.default_rng(9)
    metric = METRIC[name]
    lms = [torch.from_numpy(_points(rng, (1 << lvl, 8), d=3)).to(dtype)
           for lvl in range(3)]
    selfs = [direct_dist(z, z, metric) for z in lms]
    opts = dict(name=name, sigma=0.8)
    grouped = build_gram_dist_levels_ref(selfs, jitter=1e-3, **opts)
    for (g, c), d in zip(grouped, selfs):
        pg, pc = build_gram_dist_ref(d, jitter=1e-3, **opts)
        assert torch.equal(g, pg) and torch.equal(c, pc)
    linvs = [hck.sigma_linv(c) for _, c in grouped]
    dists = [direct_dist(torch.from_numpy(_points(rng, (4, 10), d=3))
                         .to(dtype), lms[2][:4], metric)] + [
        direct_dist(lms[lvl].reshape(1 << (lvl - 1), 16, 3), lms[lvl - 1],
                    metric) for lvl in range(1, 3)]
    cross_linvs = [linvs[2], linvs[0], linvs[1]]
    got = build_cross_dist_levels_ref(dists, cross_linvs, **opts)
    for u, d, li in zip(got, dists, cross_linvs):
        assert torch.equal(u, build_cross_dist_ref(d, li, **opts))
    # on CPU tensors the wrappers run the same plain versions, no launch
    before = (build_ops.build_gram_dist_levels.launches,
              build_ops.build_cross_dist_levels.launches)
    wg = build_ops.build_gram_dist_levels(selfs, jitter=1e-3, **opts)
    wc = build_ops.build_cross_dist_levels(dists, cross_linvs, **opts)
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(wg, grouped))
    assert all(torch.equal(a, b) for a, b in zip(wc, got))
    assert (build_ops.build_gram_dist_levels.launches,
            build_ops.build_cross_dist_levels.launches) == before


def test_grouped_stages_are_registered_beside_the_reference_stages():
    """The grouped stages (and the one-launch oos_local_walk) are the
    port's own: registered for both backends, outside the reference's
    stage list."""
    assert set(registry.PORT_STAGES) == {"build_gram_levels",
                                         "build_cross_levels",
                                         "build_gram_dist_levels",
                                         "build_cross_dist_levels",
                                         "oos_local_walk"}
    assert not set(registry.PORT_STAGES) & set(registry.STAGES)
    for stage in registry.PORT_STAGES:
        for backend in registry.BACKENDS:
            assert callable(registry.get_impl(stage, backend))
    cpu = torch.zeros(2)
    assert registry.resolve_backend(
        None, "build_cross_dist_levels", cpu) == "torch"
