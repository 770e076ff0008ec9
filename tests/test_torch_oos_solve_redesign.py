"""The B4 ``leaf_solve`` and B7 ``oos_contract`` kernels as redesigned for
Hopper (``csrc/leaf_solve.cu``, ``csrc/oos_contract.cu``) without a card.

B4's algorithm is emulated in PyTorch (float64) step for step, as the
kernel takes it: Linv's lower triangle staged by quads of 4 rows, chunk c
of the quad's rows side by side, the entries above the diagonal
zero-filled by the copy, the padding between quads never read (it is NaN
here); U staged with row 4m + e at row e nq + m and rows and columns past
n0 and r zero; or either read in place from the tensors (the form for
shapes whose staged copy does not fit).  Right-hand sides go 8 columns at
a time in two halves of 4, each output a 4 x 4 register tile summed in the
kernel's order: t = Linv b by row quads over the chunks up to the
diagonal, c = U^T b by column quads, x = Linv^T t by column quads over the
rows at and below them (lane b starts each quad at row (b + s) mod 4),
v = Sig c by row quads, and x += U v in two halves of v's chunks, the
second added last.  With NaN above Linv's diagonal the emulation still
equals the reference's Pallas ``hck_leaf_solve`` (interpret mode) on the
zero-triangle Linv: the kernel never reads that triangle.  That is safe
because every producer of the port's ``inv.linv`` writes exact zeros
there: B3's plain version and its kernel's blocked algorithm, Algorithm 2
(``invert_with_leaf``) and the update path (B13's plain version,
``invert_extend``), each checked here.

B7's one-launch form (``oos_local_walk``, both Algorithm-3 terms of every
query) is, as a plain version, exactly the sum of the two stages', and
``apply_plan`` (which takes it) matches the reference's.  Both B7 wrappers
and B4's are followed down their card path with the device check and the
ctypes launch replaced by a recorder (as in
``test_torch_kernel_variants.py``): at d 3, 54, 90, 780, middle sizes and
leaves 16, 128, 167, 240, float32 and float64, none raises, every plan
fits a block's shared memory, and the launch arguments are the ones the
kernels need (copy widths dividing every block's bytes and base address,
read widths dividing d).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_leaf_policy_redesign import blocked_factor
from test_torch_oos import flatten_model

from repro.core import oos as joos
from repro.core.hck import build_hck as jbuild_hck
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.hck_leaf import ops as jleaf
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch import convert
from repro_torch.core import hmatrix, krr, oos, update
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.kernels import _build, registry
from repro_torch.kernels.hck_leaf import ops as leaf_ops
from repro_torch.kernels.hck_leaf.ref import (hck_leaf_factor_ref,
                                              hck_leaf_solve_ref)
from repro_torch.kernels.oos_stage import ops as oos_ops
from repro_torch.kernels.oos_stage.ref import (oos_contract_ref,
                                               oos_local_walk_ref)
from repro_torch.kernels.update_stage.ref import leaf_update_ref

KG = 8          # B4's right-hand-side columns a group


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ---------------------------------------------------------------------------
# B4: the kernel's algorithm, emulated
# ---------------------------------------------------------------------------

def quad_off(m):
    """Chunk offset of quad m of the staged triangle (csrc/leaf_solve.cu)."""
    return 2 * m * (m + 1) + 5 * ((m + 1) >> 1) + (m >> 1)


def tri_chunk(i, c):
    """Element offset of chunk c of row i of the staged triangle."""
    return 4 * (quad_off(i >> 2) + 4 * c + (i & 3))


def stage_triangle(linv):
    """(P, n0, n0) -> (P, lsize): what the kernel's copy writes, NaN where
    it writes nothing."""
    p, n0, _ = linv.shape
    nq = -(-n0 // 4)
    assert leaf_ops.tri_size(n0) == 4 * quad_off(nq)
    ls = torch.full((p, 4 * quad_off(nq)), float("nan"), dtype=linv.dtype)
    for i in range(4 * nq):
        for ch in range(i // 4 + 1):
            for e in range(4):
                j = 4 * ch + e
                ls[:, tri_chunk(i, ch) + e] = (
                    linv[:, i, j] if i < n0 and j <= i else 0.0)
    return ls


def stage_u(u):
    """(P, n0, r) -> (P, 4 nq, ldu): U's row 4m + e at row e nq + m, zero
    past n0 and r, NaN in the stride's padding."""
    p, n0, r = u.shape
    nq, cu = -(-n0 // 4), -(-r // 4)
    ldu = leaf_ops.u_stride(r)
    us = torch.full((p, 4 * nq, ldu), float("nan"), dtype=u.dtype)
    us[:, :, :4 * cu] = 0.0
    for i in range(n0):
        us[:, (i & 3) * nq + (i >> 2), :r] = u[:, i]
    return us


def tile44(acc, rows, rhs):
    """acc[e][q] += rows[e][f] rhs[f][q], f in order (batched over leaves)."""
    for f in range(4):
        acc = acc + rows[:, :, f, None] * rhs[:, None, f, :]
    return acc


def emulate_leaf_solve(linv, u, sig, b, *, stage_l=True, stage_u_=True):
    """B4's kernel, emulated: (P,n0,n0),(P,n0,r),(S,r,r),(P,n0,k) -> x, c."""
    p, n0, k = b.shape
    r = u.shape[2]
    nq, cu = -(-n0 // 4), -(-r // 4)
    rows = 4 * max(nq, cu)
    shift = 0 if sig.shape[0] == p else 1
    sg = sig[torch.arange(p) >> shift]
    ls = stage_triangle(linv) if stage_l else None
    us = stage_u(u) if stage_u_ else None

    def l4(i, ch):                        # Linv[:, i, 4ch .. 4ch + 3]
        if stage_l:
            return ls[:, tri_chunk(i, ch):tri_chunk(i, ch) + 4]
        out = torch.zeros((p, 4), dtype=b.dtype)
        for e in range(4):
            j = 4 * ch + e
            if i < n0 and j <= i:
                out[:, e] = linv[:, i, j]
        return out

    def u4(i, ch):                        # U[:, i, 4ch .. 4ch + 3]
        if stage_u_:
            return us[:, (i & 3) * nq + (i >> 2), 4 * ch:4 * ch + 4]
        out = torch.zeros((p, 4), dtype=b.dtype)
        for e in range(4):
            if i < n0 and 4 * ch + e < r:
                out[:, e] = u[:, i, 4 * ch + e]
        return out

    def s4(i, ch):                        # Sig[:, min(i, r-1), 4ch .. +3]
        out = torch.zeros((p, 4), dtype=b.dtype)
        for e in range(4):
            if 4 * ch + e < r:
                out[:, e] = sg[:, min(i, r - 1), 4 * ch + e]
        return out

    x = torch.empty_like(b)
    c = torch.empty((p, r, k), dtype=b.dtype)
    for g0 in range(0, k, KG):
        kk = min(KG, k - g0)
        A = torch.zeros((p, rows, KG), dtype=b.dtype)   # b, then v
        A[:, :n0, :kk] = b[:, :, g0:g0 + kk]
        B = torch.zeros((p, rows, KG), dtype=b.dtype)   # t
        C = torch.zeros((p, rows, KG), dtype=b.dtype)   # c, then U v
        xl = torch.zeros((p, 4 * nq, KG), dtype=b.dtype)
        for h in (0, 4):
            # step 1: t = Linv b (row quads, chunks up to the diagonal)
            for m in range(nq):
                acc = torch.zeros((p, 4, 4), dtype=b.dtype)
                for ch in range(m + 1):
                    lq = torch.stack([l4(4 * m + e, ch) for e in range(4)], 1)
                    acc = tile44(acc, lq, A[:, 4 * ch:4 * ch + 4, h:h + 4])
                B[:, 4 * m:4 * m + 4, h:h + 4] = acc
            # step 1: c = U^T b (column quads, rows in order)
            for jq in range(cu):
                acc = torch.zeros((p, 4, 4), dtype=b.dtype)
                for i in range(n0):
                    acc = acc + u4(i, jq)[:, :, None] * A[:, i, None, h:h + 4]
                C[:, 4 * jq:4 * jq + 4, h:h + 4] = acc
        c[:, :, g0:g0 + kk] = C[:, :r, :kk]
        for h in (0, 4):
            # step 2: x = Linv^T t (column quads b, rows at and below them)
            for bq in range(nq):
                for qa in range(bq, nq):
                    for s in range(4):
                        i = 4 * qa + ((bq + s) & 3)
                        xl[:, 4 * bq:4 * bq + 4, h:h + 4] += (
                            l4(i, bq)[:, :, None] * B[:, i, None, h:h + 4])
            # step 2: v = Sig c (row quads)
            for m in range(cu):
                acc = torch.zeros((p, 4, 4), dtype=b.dtype)
                for jc in range(cu):
                    sq = torch.stack([s4(4 * m + e, jc) for e in range(4)], 1)
                    acc = tile44(acc, sq, C[:, 4 * jc:4 * jc + 4, h:h + 4])
                for e in range(4):
                    A[:, 4 * m + e, h:h + 4] = acc[:, e] if 4 * m + e < r else 0
        for h in (0, 4):
            # step 3: x += U v, the first half of v's chunks into x, the
            # second into C, added last
            half = (cu + 1) // 2
            for bq in range(nq):
                lo = torch.zeros((p, 4, 4), dtype=b.dtype)
                hi = torch.zeros((p, 4, 4), dtype=b.dtype)
                for jc in range(cu):
                    uq = torch.stack([u4(4 * bq + e, jc) for e in range(4)], 1)
                    vq = A[:, 4 * jc:4 * jc + 4, h:h + 4]
                    if jc < half:
                        lo = tile44(lo, uq, vq)
                    else:
                        hi = tile44(hi, uq, vq)
                xl[:, 4 * bq:4 * bq + 4, h:h + 4] += lo
                C[:, 4 * bq:4 * bq + 4, h:h + 4] = hi
        x[:, :, g0:g0 + kk] = (xl[:, :n0, :kk] + C[:, :n0, :kk])
    return x, c


def _solve_inputs(p, n0, r, k, seed):
    """Linv the exact lower-triangular inverse of an SPD leaf's Cholesky
    factor, U, one Sig a leaf, b; float64."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((p, n0, n0))
    spd = a @ a.transpose(0, 2, 1) / n0 + np.eye(n0)
    lo = torch.linalg.cholesky(_t(spd))
    linv = torch.linalg.solve_triangular(
        lo, torch.eye(n0, dtype=torch.float64).expand(p, n0, n0),
        upper=False).tril()
    return (linv, _t(rng.standard_normal((p, n0, r)) / np.sqrt(n0)),
            _t(rng.standard_normal((p, r, r)) / r),
            _t(rng.standard_normal((p, n0, k))))


@pytest.mark.parametrize("per_parent", [False, True], ids=["S=P", "S=P/2"])
@pytest.mark.parametrize("k", [1, 7, 16])
@pytest.mark.parametrize("n0, r", [(16, 8), (17, 6)])
def test_b4_emulation_matches_reference(f64, n0, r, k, per_parent):
    """The kernel's algorithm, staged and read in place, against the
    reference's Pallas kernel; NaN above Linv's diagonal changes nothing."""
    linv, u, sig, b = _solve_inputs(4, n0, r, k, 10 * n0 + k)
    if per_parent:                  # one Sig a sibling pair, read by both
        sig = sig[::2].contiguous()
    full = torch.repeat_interleave(sig, 2, 0) if per_parent else sig
    want = jleaf.leaf_solve(*(jnp.asarray(t.numpy()) for t in (linv, u, full,
                                                               b)),
                            interpret=True)
    plain = hck_leaf_solve_ref(linv, u, sig, b)
    dirty = linv + torch.triu(torch.full_like(linv, float("nan")), 1)
    for stage_l, stage_u_ in ((True, True), (True, False), (False, True),
                              (False, False)):
        got = emulate_leaf_solve(dirty, u, sig, b, stage_l=stage_l,
                                 stage_u_=stage_u_)
        for g, w, pl in zip(got, want, plain):
            assert g.shape == pl.shape
            assert _rel(g, w) <= 1e-12
            assert _rel(g, pl) <= 1e-12


def test_b4_one_pass_is_the_failing_control(f64):
    """Dropping the second half of U v (the part added last) is caught at
    the test's tolerance: the emulation's halves both count."""
    linv, u, sig, b = _solve_inputs(2, 16, 8, 7, 3)
    x, _ = emulate_leaf_solve(linv, u, sig, b)
    x0 = x - (u[:, :, 4:] @ (sig[:, 4:] @ (u.mT @ b)))
    assert _rel(x0, hck_leaf_solve_ref(linv, u, sig, b)[0]) > 1e-6


# ---------------------------------------------------------------------------
# Every producer of inv.linv writes exact zeros above the diagonal
# ---------------------------------------------------------------------------

def _upper_zero(t):
    return torch.equal(torch.triu(t, 1), torch.zeros_like(t))


def test_linv_is_exactly_lower_triangular_from_every_producer(f64):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((3, 20, 20))
    spd = _t(a @ a.transpose(0, 2, 1) / 20 + np.eye(20))
    _, li = hck_leaf_factor_ref(spd)                       # B3, plain
    _, li_blocked = blocked_factor(spd)                    # B3's kernel
    _, li_blocked32 = blocked_factor(spd.float())
    assert _upper_zero(li) and _upper_zero(li_blocked)
    assert _upper_zero(li_blocked32)
    # Algorithm 2 on a fit, then one insert: invert_extend through B13's
    # plain version
    x = rng.standard_normal((256, 5))
    y = np.sin(x[:, 0])
    ker = BaseKernel("gaussian", 2.0, 1e-8)
    m = krr.fit(x, y, kernel=ker, lam=1e-2, rank=8, leaf_size=32, levels=3,
                device="cpu", generator=torch.Generator().manual_seed(0))
    assert _upper_zero(m.inverse.linv)
    inv, lo = hmatrix.invert_with_leaf(m.factors, 1e-2)
    assert _upper_zero(inv.linv) and _upper_zero(lo)
    f2, _, rec = update.insert(m.factors, _t(rng.standard_normal((23, 5))),
                               ker, jitter_rows=32,
                               generator=torch.Generator().manual_seed(1))
    assert rec.k > 0
    b, c = hmatrix.extension_blocks(f2, n0_base=32, ridge=1e-2)
    lo_ext, li_ext = leaf_update_ref(m.leaf_lo, m.inverse.linv, b, c)
    assert _upper_zero(lo_ext) and _upper_zero(li_ext)
    inv2, _ = hmatrix.invert_extend(f2, m.leaf_lo, m.inverse.linv,
                                    n0_base=32, ridge=1e-2)
    assert inv2.linv.shape[-1] == 32 + rec.k and _upper_zero(inv2.linv)


# ---------------------------------------------------------------------------
# B7: the one-launch form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gaussian", "imq", "laplace"])
def test_b7_one_launch_plain_form_is_the_two_stage_sum(f64, name):
    rng = np.random.default_rng(4)
    xl, wl = _t(rng.standard_normal((8, 16, 3))), _t(rng.standard_normal(
        (8, 16, 2)))
    lm, ct = _t(rng.standard_normal((4, 8, 3))), _t(rng.standard_normal(
        (8, 8, 2)))
    qs = _t(rng.standard_normal((30, 3)))
    leaf = torch.from_numpy(np.sort(rng.integers(0, 8, 30)))
    parent = leaf >> 1
    local = oos_contract_ref(xl, wl, qs, leaf, leaf, name=name, sigma=1.3)
    walk = oos_contract_ref(lm, ct, qs, parent, leaf, name=name, sigma=1.3)
    for got in (oos_local_walk_ref(xl, wl, lm, ct, qs, leaf, parent,
                                   name=name, sigma=1.3),
                oos_ops.oos_local_walk(xl, wl, lm, ct, qs, leaf, parent,
                                       name=name, sigma=1.3),
                registry.get_impl("oos_local_walk", "torch")(
                    xl, wl, lm, ct, qs, leaf, parent, name=name,
                    sigma=1.3)):
        assert torch.equal(got, local + walk)


def test_apply_plan_through_the_one_launch_form_matches_reference(f64):
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((256, 3)), rng.standard_normal((256, 2))
    ker = JKernel("gaussian", sigma=1.5, jitter=1e-8)
    f = jbuild_hck(jnp.asarray(x), levels=4, rank=8,
                   key=jax.random.PRNGKey(1), kernel=ker)
    jplan = joos.prepare(f, jnp.asarray(w))
    arrays = flatten_model(f, jplan)
    pf = convert.factors_from_arrays(arrays, device="cpu")
    plan = convert.plan_from_arrays(arrays, device="cpu")
    q = rng.standard_normal((41, 3))
    got = oos.apply_plan(pf, plan, _t(q), BaseKernel("gaussian", 1.5, 1e-8))
    for backend in ("xla", "pallas"):
        want = joos.apply_plan(f, jplan, jnp.asarray(q), ker,
                               JSolveConfig(backend=backend, interpret=True))
        assert _rel(got, want) <= 1e-10


# ---------------------------------------------------------------------------
# The wrappers' card path, launch recorded
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
    for fn, attrs in ((oos_ops.oos_contract, ("launches", "pair_launches")),
                      (leaf_ops.leaf_solve, ("launches",))):
        for attr in attrs:
            monkeypatch.setattr(fn, attr, 0)
    return calls


def _check_segment(args, points, weights, rows):
    """A segment's launch arguments: its tensors, sizes and copy widths
    (each dividing the base address, a block's bytes and a chunk's)."""
    assert args[0] is points and args[1] is weights
    bp, m, d = points.shape
    k, s = weights.shape[2], points.element_size()
    assert (args[4].value, args[5].value, args[6]) == (bp, weights.shape[0],
                                                       m)
    for width, t, cols in ((args[7], points, d), (args[8], weights, k)):
        assert width in (4, 8, 16) and width >= min(s, 16)
        for n in (t.data_ptr(), m * cols * s, min(rows, m) * cols * s):
            assert n % width == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("m", [16, 128, 167, 240])
@pytest.mark.parametrize("d", [3, 54, 90, 780])
def test_b7_wrappers_plan_and_launch(fake_card, d, m, dtype):
    k, q = 7 if d < 780 else 10, 5
    pts, wts = torch.zeros((4, m, d), dtype=dtype), torch.zeros((4, m, k),
                                                                dtype=dtype)
    lm, ct = torch.zeros((2, 128, d), dtype=dtype), torch.zeros((4, 128, k),
                                                                dtype=dtype)
    qs = torch.zeros((q, d), dtype=dtype)
    idx = torch.tensor([0, 0, 1, 3, 3])
    par = idx >> 1
    z1 = oos_ops.oos_contract(pts, wts, qs, idx, idx)
    z2 = oos_ops.oos_local_walk(pts, wts, lm, ct, qs, idx, par)
    assert z1.shape == z2.shape == (q, k)
    assert (oos_ops.oos_contract.launches,
            oos_ops.oos_contract.pair_launches) == (2, 1)
    s = pts.element_size()
    for (name, symbol, args), nseg, ms in zip(fake_card, (1, 2),
                                              ((m,), (m, 128))):
        assert (name, symbol) == ("oos_contract", "oos_contract_"
                                  + _build.SUFFIX[dtype])
        plan = oos_ops.plan(ms, d, k, s)
        tail = args[18:]
        assert tail[0] == nseg and tail[1] is qs
        assert tail[3:11] == (q, d, k, plan["rows"], plan["warps"],
                              tail[8], tail[9], plan["pslot"])
        rows, warps, xw, vw = tail[6], tail[7], tail[8], tail[9]
        assert 1 <= rows <= max(ms) and 1 <= warps <= oos_ops.MAX_WARPS
        assert plan["smem"] <= oos_ops.SMEM_BUDGET
        assert (qs.data_ptr() % xw, d * s % xw) == (0, 0)
        assert d % vw == 0 and vw * s <= 16
        # whole blocks where one warp's slots fit, else chunks of rows
        whole = oos_ops.warp_smem(max(ms), d, k, s) <= oos_ops.SMEM_BUDGET
        assert (rows == max(ms)) == whole
        _check_segment(args[:9], pts, wts, rows)
        if nseg == 2:
            _check_segment(args[9:18], lm, ct, rows)
            assert args[11] is par and args[12] is idx
        else:
            assert args[9:13] == (None,) * 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 7, 16])
@pytest.mark.parametrize("n0", [16, 128, 167, 240])
def test_b4_wrapper_plan_and_launch(fake_card, n0, k, dtype):
    r = min(n0, 128)
    p = 4
    linv, u = torch.zeros((p, n0, n0), dtype=dtype), torch.zeros(
        (p, n0, r), dtype=dtype)
    b = torch.zeros((p, n0, k), dtype=dtype)
    for s, shift in ((p, 0), (p // 2, 1)):
        sig = torch.zeros((s, r, r), dtype=dtype)
        x, c = leaf_ops.leaf_solve(linv, u, sig, b)
        assert x.shape == (p, n0, k) and c.shape == (p, r, k)
        name, symbol, args = fake_card[-1]
        assert (name, symbol) == ("leaf_solve", "leaf_solve_"
                                  + _build.SUFFIX[dtype])
        assert all(a is t for a, t in zip(args, (linv, u, sig, b, x, c)))
        plan = leaf_ops.solve_plan(n0, r, k, b.element_size(),
                                   linv.data_ptr(), u.data_ptr(),
                                   sig.data_ptr())
        assert args[6:] == (p, n0, r, k, shift, int(plan["stage_l"]),
                            int(plan["stage_u"]), plan["lw"], plan["uw"],
                            plan["sw"], plan["ldu"], plan["lsize"])
        assert plan["smem"] <= _build.SMEM_MAX
        assert plan["ldu"] >= r and (plan["ldu"] // 4) % 2 == 1
    assert leaf_ops.leaf_solve.launches == 2
    with pytest.raises(ValueError, match="512 rows"):
        leaf_ops.leaf_solve(torch.zeros((1, 513, 513)),
                            torch.zeros((1, 513, 8)), torch.zeros((1, 8, 8)),
                            torch.zeros((1, 513, 1)))
    assert leaf_ops.leaf_solve.launches == 2
    # the fit's shape stages both, two blocks an SM
    fit = leaf_ops.solve_plan(128, 128, 7, 4)
    assert fit["stage_l"] and fit["stage_u"]
    assert 2 * (fit["smem"] + 1024) <= 228 * 1024


def test_cpu_tensors_launch_nothing(f64):
    linv, u, sig, b = _solve_inputs(2, 16, 8, 3, 5)
    before = (leaf_ops.leaf_solve.launches, oos_ops.oos_contract.launches)
    x, c = leaf_ops.leaf_solve(linv, u, sig, b)
    want = hck_leaf_solve_ref(linv, u, sig, b)
    assert torch.equal(x, want[0]) and torch.equal(c, want[1])
    idx = torch.zeros(3, dtype=torch.int64)
    oos_ops.oos_local_walk(u, b, u, b, torch.zeros((3, 8),
                                                   dtype=torch.float64),
                           idx, idx)
    assert (leaf_ops.leaf_solve.launches,
            oos_ops.oos_contract.launches) == before
