"""The B5 ``leaf_matvec`` and B13 ``leaf_update`` kernels as redesigned for
Hopper (``csrc/leaf_matvec.cu``, ``csrc/leaf_update.cu``, both streaming
a leaf through ``csrc/leaf_stream.cuh``) without a card.

Each plain version is held against the reference's Pallas kernel in
interpret mode (``hck_leaf_matvec``, ``hck_leaf_update``) in float64 at
n0 16, 17 and 142 with k 1, 7 and 16 (and k 33 for B13, past one
32-column panel of its factor).  Each kernel's arithmetic is emulated in
PyTorch step for step, in its order of sums:

- B5: y = A b a row at a time, lane l of the row's warp summing j = l, l +
  32, ... in one chain of fused multiply-adds, the 32 lanes' partial sums
  then added pairwise at distance 16, 8, 4, 2, 1 (warp_sum_spread);
  c = U^T b a column at a time in two chains, the even and the odd rows
  (carried from panel to panel; a panel's 32 or 16 rows start even), then
  added.
- B13: L21^T = Linv B^T as B5's y; T = L21 Linv a column at a time in one
  chain over all rows; S = C - (one chain over n0 of L21 L21^T); L22 by
  B3's blocked factor (``blocked_factor`` of
  ``tests/test_torch_leaf_policy_redesign.py``: chol_blocked.cuh's
  factor_panels) and its reciprocal pivots; X = L22^-1 a column at a time
  by forward substitution (each step a fused multiply-add, times the
  reciprocal pivot); -X T one chain per entry; the leading quadrants
  copied.

The emulation is held to 1e-12 of the reference in float64 and, in
float32 (each fused multiply-add rounded once through float64), to the
card's gates: 1e-4 relative (``chip_smoke.check_leaf`` and
``check_update_kernel``), the old quadrants bit for bit, also where the
inputs hold non-zeros above the diagonal (the products then use Linv's
whole rows, as the reference does).  Both wrappers are followed down
their card path with the device check and the ctypes launch replaced by a
recorder: the k = 1 instance, the panels' rows, blocks an SM and shared
memory, the copy widths, B5's launches by (n0, r, k) and its chunks for
wide b.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_leaf_policy_redesign import _fma, blocked_factor

from repro.kernels.hck_leaf.hck_leaf import hck_leaf_matvec as jmatvec
from repro.kernels.update_stage.update_stage import hck_leaf_update as jupdate
from repro_torch.kernels import _build, leaf_stream
from repro_torch.kernels.hck_leaf import ops as leaf_ops
from repro_torch.kernels.hck_leaf.ref import hck_leaf_matvec_ref
from repro_torch.kernels.update_stage import ops as update_ops
from repro_torch.kernels.update_stage.ref import leaf_update_ref

P = 3           # leaves
R_OF = {16: 8, 17: 9, 142: 128}
MATVEC_SHAPES = [(n0, k) for n0 in (16, 17, 142) for k in (1, 7, 16)]
UPDATE_SHAPES = MATVEC_SHAPES + [(142, 33)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


# ---------------------------------------------------------------------------
# Inputs and the reference's outputs, one reference call a leaf size: the
# columns of b are independent, and the extension by k' < k rows is the
# leading block of the extension by k (a bordered Cholesky factor and its
# inverse are nested)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _matvec_full(n0):
    rng = np.random.default_rng(1000 + n0)
    args = (rng.standard_normal((P, n0, n0)),
            rng.standard_normal((P, n0, R_OF[n0])),
            rng.standard_normal((P, n0, 16)))
    y, c = jmatvec(*map(jnp.asarray, args), interpret=True)
    return args, (np.asarray(y), np.asarray(c))


def matvec_case(n0, k):
    """(adiag, u, b) and the reference's (y, c), float64 numpy."""
    (a, u, b), (y, c) = _matvec_full(n0)
    return (a, u, b[..., :k]), (y[..., :k], c[..., :k])


@functools.lru_cache(maxsize=None)
def _update_full(n0, junk):
    kmax = max(k for m, k in UPDATE_SHAPES if m == n0)
    rng = np.random.default_rng(2000 + n0 + junk)
    a = rng.standard_normal((P, n0 + kmax, n0 + kmax))
    full = a @ a.transpose(0, 2, 1) / (n0 + kmax) + np.eye(n0 + kmax)
    lo = np.linalg.cholesky(full[:, :n0, :n0])
    linv = np.tril(np.linalg.inv(lo))
    if junk:
        up = np.triu(rng.standard_normal((P, n0, n0)), 1)
        lo, linv = lo + up, linv + 1e-3 * up
    args = (lo, linv, full[:, n0:, :n0], full[:, n0:, n0:])
    out = jupdate(*map(jnp.asarray, args), interpret=True)
    return args, (np.asarray(out[0]), np.asarray(out[1]))


def update_case(n0, k, junk=False):
    """(lo, linv, b, c) of a bordered SPD matrix (with ``junk``, non-zeros
    above both factors' diagonals) and the reference's (lo_ext,
    linv_ext), float64 numpy."""
    (lo, linv, b, c), outs = _update_full(n0, junk)
    ne = n0 + k
    return ((lo, linv, b[:, :k].copy(), c[:, :k, :k].copy()),
            tuple(o[:, :ne, :ne] for o in outs))


# ---------------------------------------------------------------------------
# The kernels' arithmetic, emulated
# ---------------------------------------------------------------------------

def lane_tree(part):
    """warp_sum_spread over the last axis (32 lanes): pairs at distance 16,
    8, 4, 2, 1 added (every lane ends with the same sum)."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ o]
    return part[..., 0]


def rows_times(m, x):
    """rows_times: out[i][q] = sum_j m[i][j] x[j][q], lane l summing j = l,
    l + 32, ... in a chain of fused multiply-adds, then the lane tree.
    m (P, rows, n), x (P, n, k) -> (P, rows, k)."""
    p, rows, n = m.shape
    k = x.shape[2]
    steps = -(-n // 32)
    mp = torch.zeros((p, rows, 32 * steps), dtype=m.dtype)
    xp = torch.zeros((p, 32 * steps, k), dtype=m.dtype)
    mp[:, :, :n], xp[:, :n] = m, x
    mp = mp.view(p, rows, steps, 32)
    xp = xp.view(p, steps, 32, k)
    acc = torch.zeros((p, rows, k, 32), dtype=m.dtype)
    for t in range(steps):                      # j = 32 t + lane
        acc = _fma(mp[:, :, None, t, :], xp[:, None, t].mT, acc)
    return lane_tree(acc)


def col_chain(m, x, rows):
    """sum over ``rows`` (ascending) of m[i][j] x[i][q] in one chain of
    fused multiply-adds from 0: (P, r, k)."""
    acc = torch.zeros((m.shape[0], m.shape[2], x.shape[2]), dtype=m.dtype)
    for i in rows:
        acc = _fma(m[:, i, :, None], x[:, i, None, :], acc)
    return acc


def emulate_matvec(a, u, b):
    """B5: y by rows_times, c as two row groups' chains, then group 0 +
    group 1.  Group g takes rows g, g + 2, ... of each panel; a panel's
    rows (32 or 16) start even and its sums stay in shared memory from
    panel to panel, so each group is one chain over the rows of its
    parity."""
    n0 = a.shape[1]
    y = rows_times(a, b)
    groups = [col_chain(u, b, range(g, n0, 2)) for g in (0, 1)]
    return y, groups[0] + groups[1]


def emulate_update(lo, linv, b, c):
    """B13: (lo_ext, linv_ext) in the kernel's order of sums."""
    p, n0, _ = lo.shape
    k = b.shape[1]
    dt = lo.dtype
    l21t = rows_times(linv, b.mT)                     # (P, n0, k)
    tt = col_chain(linv, l21t, range(n0))             # T^T (P, n0, k)
    d = torch.zeros((p, k, k), dtype=dt)
    for m in range(n0):
        d = _fma(l21t[:, m, :, None], l21t[:, m, None, :], d)
    s = torch.tril(c - d)
    l22, _ = blocked_factor(s)
    rd = 1 / torch.diagonal(l22, dim1=1, dim2=2)
    x = torch.zeros((p, k, k), dtype=dt)
    for col in range(k):
        for i in range(col, k):
            v = torch.full((p,), 1.0 if i == col else 0.0, dtype=dt)
            for m in range(col, i):
                v = _fma(-l22[:, i, m], x[:, m, col], v)
            x[:, i, col] = v * rd[:, i]
    li21 = torch.zeros((p, k, n0), dtype=dt)
    for q in range(k):
        acc = torch.zeros((p, n0), dtype=dt)
        for m in range(q + 1):
            acc = _fma(x[:, q, m, None], tt[:, :, m], acc)
        li21[:, q] = -acc
    ne = n0 + k
    lo_ext = torch.zeros((p, ne, ne), dtype=dt)
    linv_ext = torch.zeros((p, ne, ne), dtype=dt)
    lo_ext[:, :n0, :n0], linv_ext[:, :n0, :n0] = lo, linv
    lo_ext[:, n0:, :n0], lo_ext[:, n0:, n0:] = l21t.mT, l22
    linv_ext[:, n0:, :n0], linv_ext[:, n0:, n0:] = li21, x
    return lo_ext, linv_ext


def _t(a, dtype=torch.float64):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n0,k", MATVEC_SHAPES)
def test_b5_plain_matches_reference(f64, n0, k):
    args, want = matvec_case(n0, k)
    got = hck_leaf_matvec_ref(*map(_t, args))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


@pytest.mark.parametrize("n0,k", MATVEC_SHAPES)
def test_b5_emulation_matches_reference(f64, n0, k):
    args, want = matvec_case(n0, k)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        got = emulate_matvec(*(_t(a, dtype) for a in args))
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert _rel(g, w) <= tol, (dtype, _rel(g, w))


def test_b5_lane_tree_is_the_kernels_order():
    """In float32 the lane tree differs from a plain sum (so the emulation
    carries the order), and a row's result depends only on its own row."""
    rng = np.random.default_rng(5)
    a = _t(rng.standard_normal((1, 4, 200)) * 1e3, torch.float32)
    x = _t(rng.standard_normal((1, 200, 3)), torch.float32)
    got = rows_times(a, x)
    assert not torch.equal(got, a @ x)
    assert torch.equal(rows_times(a[:, 2:3], x), got[:, 2:3])


# ---------------------------------------------------------------------------
# B13
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n0,k", UPDATE_SHAPES)
def test_b13_plain_matches_reference(f64, n0, k):
    args, want = update_case(n0, k)
    got = leaf_update_ref(*map(_t, args))
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-12


@pytest.mark.parametrize("n0,k", UPDATE_SHAPES)
def test_b13_emulation_matches_reference(f64, n0, k):
    args, want = update_case(n0, k)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        ins = [_t(a, dtype) for a in args]
        got = emulate_update(*ins)
        for g, w, old in zip(got, want, ins[:2]):
            assert torch.equal(g[:, :n0, :n0], old)
            assert not g[:, :n0, n0:].any()
            assert not torch.triu(g[:, n0:, n0:], 1).any()
            assert _rel(g[:, n0:], w[:, n0:]) <= tol, (dtype, _rel(g, w))


@pytest.mark.parametrize("n0,k", [(17, 7), (142, 16)])
def test_b13_quadrants_bit_for_bit_with_junk_above_diagonal(f64, n0, k):
    """Non-zeros above the inputs' diagonals: the plain version and the
    kernel's order keep both quadrants bit for bit, and the new rows (whole
    rows of Linv in both products) still match the reference."""
    args, want = update_case(n0, k, junk=True)
    ins = [_t(a) for a in args]
    assert torch.triu(ins[0], 1).any() and torch.triu(ins[1], 1).any()
    for got in (leaf_update_ref(*ins), emulate_update(*ins)):
        for g, w, old in zip(got, want, ins[:2]):
            assert torch.equal(g[:, :n0, :n0], old)
            assert np.array_equal(w[:, :n0, :n0], old.numpy())
            assert _rel(g[:, n0:], w[:, n0:]) <= 1e-12


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
    monkeypatch.setattr(leaf_ops.leaf_matvec, "launches", 0)
    monkeypatch.setattr(leaf_ops.leaf_matvec, "shapes",
                        type(leaf_ops.leaf_matvec.shapes)())
    monkeypatch.setattr(update_ops.leaf_update, "launches", 0)
    monkeypatch.setattr(update_ops.leaf_update, "panel_launches", 0)
    return calls


def _check_ring(plan, itemsize):
    """A ring's plan: panels of 32 or 16 rows, the shared memory within a
    block's and, at two blocks an SM (float32 only, as the kernels' launch
    bounds allow), within half an SM's."""
    assert plan["rows"] in leaf_stream.PANEL_ROWS
    assert plan["smem"] <= _build.SMEM_MAX
    assert plan["per_sm"] in ((2, 1) if itemsize == 4 else (1,))
    if plan["per_sm"] == 2:
        assert 2 * (plan["smem"] + 1024) <= leaf_stream.SMEM_SM


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n0,r,k", [(128, 128, 1), (128, 128, 7),
                                    (142, 128, 7), (167, 128, 16),
                                    (142, 128, 33), (16, 8, 1), (17, 9, 3),
                                    (24, 8, 9)])
def test_b5_wrapper_plan_and_launch(fake_card, n0, r, k, dtype):
    z = functools.partial(torch.zeros, dtype=dtype)
    a, u, b = z((4, n0, n0)), z((4, n0, r)), z((4, n0, k))
    y, c = leaf_ops.leaf_matvec(a, u, b)
    assert y.shape == (4, n0, k) and c.shape == (4, r, k)
    s = a.element_size()
    if leaf_ops.matvec_plan(n0, r, k, s)["smem"] > _build.SMEM_MAX:
        # f64 at 142 x 33: matvec_max_rhs columns, then the one left (the
        # k = 1 instance)
        w = leaf_ops.matvec_max_rhs(n0, r, s)
        assert (dtype, n0, k, w) == (torch.float64, 142, 33, 32)
        assert [args[8] for _, _, args in fake_card] == [32, 1]
        assert [args[10] for _, _, args in fake_card] == [8, 1]
        return
    (name, symbol, args), = fake_card
    assert (name, symbol) == ("leaf_matvec",
                              "leaf_matvec_" + _build.SUFFIX[dtype])
    assert all(g is t for g, t in zip(args, (a, u, b, y, c)))
    plan = leaf_ops.matvec_plan(n0, r, k, s, a.data_ptr(), u.data_ptr())
    assert args[5:] == (4, n0, r, k, plan["rows"], plan["kt"], plan["ldb"],
                        plan["va"], plan["vu"], plan["per_sm"], plan["smem"])
    # the k = 1 instance for a single column, else tiles of 8
    kt = plan["kt"]
    assert kt == (1 if k == 1 else 8)
    ldb = plan["ldb"]
    assert ldb == 1 if k == 1 else (ldb >= -(-k // kt) * kt
                                    and ldb % 4 == 0 and (ldb // 4) % 2 == 1)
    assert plan["va"] == plan["vu"] == 16 // s
    _check_ring(plan, s)
    # the covtype shapes: two blocks an SM, panels of 32 rows, one panel
    # a block in flight: >= 32 KB an SM
    if (n0, r) == (128, 128) and dtype == torch.float32:
        in_flight = plan["per_sm"] * (leaf_stream.panel_bytes(32, n0, s)
                                      + leaf_stream.panel_bytes(32, r, s))
        assert plan["per_sm"] == 2 and plan["rows"] == 32
        assert in_flight >= 32 * 1024
    assert leaf_ops.leaf_matvec.launches == 1
    assert leaf_ops.leaf_matvec.shapes == {(n0, r, k): 1}


def test_b5_wrapper_misaligned_and_wide(fake_card):
    # U a view one element in: its copies go one element at a time
    base = torch.zeros(4 * 128 * 128 + 1)
    u = base[1:].view(4, 128, 128)
    leaf_ops.leaf_matvec(torch.zeros(4, 128, 128), u, torch.zeros(4, 128, 7))
    args = fake_card[-1][2]
    assert (args[12], args[13]) == (4, 1)
    # b wider than one launch takes: chunks of matvec_max_rhs columns
    w = leaf_ops.matvec_max_rhs(128, 128, 4)
    assert w % 8 == 0 and w >= 64
    k = 2 * w + 5
    y, c = leaf_ops.leaf_matvec(torch.zeros(4, 128, 128),
                                torch.zeros(4, 128, 128),
                                torch.zeros(4, 128, k))
    assert y.shape == (4, 128, k) and c.shape == (4, 128, k)
    widths = [args[8] for _, _, args in fake_card[1:]]
    assert widths == [w, w, 5]
    assert leaf_ops.leaf_matvec.launches == 4
    for _, _, args in fake_card[1:]:
        assert args[-1] <= _build.SMEM_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n0,k", [(128, 14), (142, 12), (154, 13),
                                  (128, 25), (16, 1), (17, 7), (142, 33)])
def test_b13_wrapper_plan_and_launch(fake_card, n0, k, dtype):
    z = functools.partial(torch.zeros, dtype=dtype)
    lo, li, b, c = z((4, n0, n0)), z((4, n0, n0)), z((4, k, n0)), z((4, k, k))
    s = lo.element_size()
    plan = update_ops.update_plan(n0, k, s, lo.data_ptr(), li.data_ptr())
    if plan["smem"] > _build.SMEM_MAX:
        # f64 at 142 + 33: beyond one block's shared memory, the panel form
        assert (dtype, n0, k) == (torch.float64, 142, 33)
        lo_ext, li_ext = update_ops.leaf_update(lo, li, b, c)
        (name, symbol, args), = fake_card
        assert (name, symbol) == ("leaf_update_panel",
                                  "leaf_update_panel_f64")
        assert args[7:] == (4, n0, k) and args[6].shape == (4, 2, k, k)
        assert update_ops.leaf_update.panel_launches == 1
        return
    lo_ext, li_ext = update_ops.leaf_update(lo, li, b, c)
    assert lo_ext.shape == li_ext.shape == (4, n0 + k, n0 + k)
    (name, symbol, args), = fake_card
    assert (name, symbol) == ("leaf_update",
                              "leaf_update_" + _build.SUFFIX[dtype])
    assert all(g is t for g, t in zip(args, (lo, li, b, c, lo_ext, li_ext)))
    assert args[6:] == (4, n0, k, plan["rows"], plan["ldk"], plan["vl"],
                        plan["vi"], plan["per_sm"], plan["smem"])
    ldk = plan["ldk"]
    assert ldk >= -(-k // 8) * 8 and ldk % 4 == 0 and (ldk // 4) % 2 == 1
    _check_ring(plan, s)
    # both update rounds' covtype shapes: two blocks an SM, panels of 32
    if dtype == torch.float32 and k < 16 and n0 >= 128:
        assert plan["per_sm"] == 2
        assert plan["rows"] == 32 or n0 > 142
    assert update_ops.leaf_update.launches == 1
