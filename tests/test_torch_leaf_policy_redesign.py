"""The blocked B3 ``leaf_factor`` kernel and the register-tiled B12
``policy_dist`` kernel (``csrc/leaf_factor.cu``, ``csrc/policy_dist.cu``)
without a card.

B3's algorithm is emulated in PyTorch step for step, as the kernel takes
it: panels of 32 columns; in each, the diagonal block factored column by
column (right-looking, each column scaled by the reciprocal of its
pivot), the rows below solved by forward substitution with those
reciprocals, the trailing lower triangle updated one
panel column at a time; then L^-1 by block columns from the right, each
row a back substitution x L_jj = e - sum_k X_ik L_kj.  Every multiply-add
of the kernel is one fused operation, emulated in float32 through
float64, where the product is exact (in float64 it rounds twice: the CPU
has no fused multiply-add to call).  The emulation is held against the
reference's Pallas ``hck_leaf_factor`` in interpret mode and against the
port's plain version, at the card's gates (``chip_smoke.check_factor``):
L within 1e-4 relative in float32 and 1e-10 in float64 (L^-1 too in
float64), |L L^T - D| <= 2 (n0 + 1) eps |L||L|^T on the lower triangle
and |L^-1 L - I| <= 2 n0 eps |L^-1||L| entry by entry, both residuals
taken in float64 from the factors.  The leaves are Gaussian Grams of
close points plus a ridge of 1e-2 (kappa ~4e3 to 7e3), at n0 = 16, 128
and the grown leaf sizes 142 and 167.

The wrappers are followed down their card path with the device check and
the ctypes launch replaced by a recorder (as in
``test_torch_kernel_variants.py``): which kernel each launches, with
which arguments, for ragged shapes, "l1", and at the limits of n0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hck_leaf import ops as jleaf
from repro_torch.kernels import _build
from repro_torch.kernels.hck_leaf import ops as leaf_ops
from repro_torch.kernels.hck_leaf.ref import hck_leaf_factor_ref
from repro_torch.kernels.policy_stage import ops as policy_ops
from repro_torch.kernels.policy_stage.ref import policy_dist_ref

NB = 32     # B3's panel width (csrc/leaf_factor.cu)


def _fma(a, b, c):
    """a * b + c, rounded once in float32 (the float64 product of two
    floats is exact); in float64, two roundings."""
    if c.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def blocked_factor(dleaf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B3's blocked kernel, emulated: (P, n0, n0) -> (L, L^-1)."""
    p, n0, _ = dleaf.shape
    a = torch.tril(dleaf).clone()
    rd = torch.empty((p, n0), dtype=dleaf.dtype)
    for kb in range(0, n0, NB):
        e = min(kb + NB, n0)
        w = e - kb
        for j in range(kb, e):                 # 1. the diagonal block
            piv = torch.sqrt(a[:, j, j])
            rd[:, j] = 1 / piv
            a[:, j + 1:e, j] = a[:, j + 1:e, j] * rd[:, j, None]
            a[:, j, j] = piv
            col = a[:, j + 1:e, j]
            blk = a[:, j + 1:e, j + 1:e]
            low = torch.ones(blk.shape[1:], dtype=torch.bool).tril()
            a[:, j + 1:e, j + 1:e] = torch.where(
                low, _fma(-col[:, :, None], col[:, None, :], blk), blk)
        if e == n0:
            break
        y = a[:, e:, kb:e].clone()               # 2. L21 = A21 L11^-T
        for j in range(w):
            yj = y[:, :, j] * rd[:, kb + j, None]
            y[:, :, j] = yj
            y[:, :, j + 1:] = _fma(-yj[:, :, None],
                                   a[:, None, kb + j + 1:e, kb + j],
                                   y[:, :, j + 1:])
        a[:, e:, kb:e] = y
        acc = a[:, e:, e:].clone()               # 3. A22 -= L21 L21^T
        for k in range(w):
            acc = _fma(-y[:, :, k, None], y[:, None, :, k], acc)
        low = torch.ones(acc.shape[1:], dtype=torch.bool).tril()
        a[:, e:, e:] = torch.where(low, acc, a[:, e:, e:])
    lo = a.clone()
    for j0 in reversed(range(0, n0, NB)):        # L^-1, block columns
        e = min(j0 + NB, n0)
        w = e - j0
        rhs = torch.zeros((p, n0 - j0, w), dtype=dleaf.dtype)
        rhs[:, :w, :w] = torch.eye(w, dtype=dleaf.dtype)
        for k in range(e, n0):                   # X right of j0, L in it
            rhs = _fma(-a[:, j0:, k, None], a[:, None, k, j0:e], rhs)
        for c in reversed(range(w)):             # x L_jj = rhs
            xc = rhs[:, :, c] * rd[:, j0 + c, None]
            rhs[:, :, c] = xc
            rhs[:, :, :c] = _fma(-xc[:, :, None],
                                 a[:, None, j0 + c, j0:j0 + c], rhs[:, :, :c])
        a[:, j0:, j0:e] = rhs
    return lo, a


def _leaves(p, n0, seed):
    """Gaussian Grams of p x n0 close points in 54 features (mean squared
    distance ~0.5 at sigma 1) plus 1e-2 I: SPD, kappa ~4e3 to 7e3 at n0 >=
    128."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((p, n0, 54)) * (0.5 / np.sqrt(54))
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2) + 1e-2 * np.eye(n0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _gates(dleaf, lo, li):
    """The card's two backward-error gates, residuals in float64."""
    n0 = dleaf.shape[-1]
    eps = torch.finfo(dleaf.dtype).eps
    d, l, x = dleaf.double(), lo.double(), li.double()
    back = (l @ l.mT - d).tril().abs()
    assert bool((back <= 2 * (n0 + 1) * eps * (l.abs() @ l.abs().mT)).all())
    inv = (x @ l - torch.eye(n0, dtype=torch.float64)).abs()
    assert bool((inv <= 2 * n0 * eps * (x.abs() @ l.abs())).all())


@pytest.mark.parametrize("n0", [16, 128, 142, 167])
def test_b3_blocked_emulation_f32(n0):
    spd = _leaves(3, n0, n0).astype(np.float32)
    want_lo, _ = jleaf.leaf_factor(jnp.asarray(spd), interpret=True)
    d = torch.from_numpy(spd)
    lo, li = blocked_factor(d)
    plain_lo, _ = hck_leaf_factor_ref(d)
    assert lo.dtype == li.dtype == torch.float32
    assert _rel(lo, want_lo) <= 1e-4
    assert _rel(lo, plain_lo) <= 1e-4
    assert torch.equal(lo, lo.tril()) and torch.equal(li, li.tril())
    _gates(d, lo, li)


@pytest.mark.parametrize("n0", [16, 142])
def test_b3_blocked_emulation_f64(f64, n0):
    spd = _leaves(2, n0, 100 + n0)
    want_lo, want_li = jleaf.leaf_factor(jnp.asarray(spd), interpret=True)
    d = torch.from_numpy(spd)
    lo, li = blocked_factor(d)
    plain_lo, plain_li = hck_leaf_factor_ref(d)
    for got, want in ((lo, want_lo), (li, want_li), (lo, plain_lo),
                      (li, plain_li)):
        assert _rel(got, want) <= 1e-10
    _gates(d, lo, li)


def test_b3_blocked_emulation_indefinite_gives_nan():
    """No pivot clamp: a leaf that is not positive definite gets NaN, its
    neighbour in the batch does not."""
    bad = torch.eye(40).expand(2, 40, 40).clone()
    bad[1, 35, 35] = -1.0                        # in the ragged last panel
    lo, li = blocked_factor(bad)
    assert bool(torch.isnan(lo[1]).any() and torch.isnan(li[1]).any())
    assert torch.equal(lo[0], torch.eye(40)) and torch.equal(li[0],
                                                             torch.eye(40))


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
    for fn, attrs in ((leaf_ops.leaf_factor, ("launches",)),
                      (policy_ops.policy_dist, ("launches",
                                                "tiled_launches"))):
        for attr in attrs:
            monkeypatch.setattr(fn, attr, 0)
    return calls


@pytest.mark.parametrize("n0, itemsize, ok", [
    (16, 4, True), (128, 4, True), (142, 4, True), (167, 4, True),
    (240, 4, True), (241, 4, False), (128, 8, True), (169, 8, True),
    (170, 8, False)])
def test_b3_limits(fake_card, n0, itemsize, ok):
    """The blocked kernel takes n0 <= 240 in float32 and <= 169 in float64
    (as the design it replaced did); beyond, the wrapper launches the panel
    form (leaf_factor_panel.cu), up to n0 512, and raises past 512, before
    any launch."""
    assert ok == (leaf_ops.factor_smem(n0, itemsize) <= _build.SMEM_MAX)
    dtype = {4: torch.float32, 8: torch.float64}[itemsize]
    leaf_ops.leaf_factor(torch.zeros((1, n0, n0), dtype=dtype))
    lib = "leaf_factor" if ok else "leaf_factor_panel"
    assert fake_card[0][:2] == (lib, f"{lib}_{_build.SUFFIX[dtype]}")
    with pytest.raises(ValueError, match="above m = 512.*panel form"):
        leaf_ops.leaf_factor(torch.zeros((1, 513, 513), dtype=dtype))
    assert len(fake_card) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n0", [16, 142])
def test_b3_wrapper_launches_the_blocked_kernel(fake_card, dtype, n0):
    dleaf = torch.zeros((5, n0, n0), dtype=dtype)
    lo, linv = leaf_ops.leaf_factor(dleaf)
    (name, symbol, args), = fake_card
    assert (name, symbol) == ("leaf_factor", "leaf_factor_"
                              + _build.SUFFIX[dtype])
    assert args[0] is dleaf and args[1] is lo and args[2] is linv
    assert args[3:] == (5, n0)
    assert leaf_ops.leaf_factor.launches == 1
    lo0, linv0 = leaf_ops.leaf_factor(torch.zeros((0, n0, n0), dtype=dtype))
    assert lo0.shape == linv0.shape == (0, n0, n0)
    leaf_ops.leaf_factor(torch.zeros((1, 241, 241)))
    assert fake_card[-1][1] == "leaf_factor_panel_f32"
    with pytest.raises(ValueError, match="panel form"):
        leaf_ops.leaf_factor(torch.zeros((1, 513, 513)))
    assert len(fake_card) == 2 and leaf_ops.leaf_factor.launches == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("d", [1, 54, 64, 65, 780])
def test_b12_route(dtype, d):
    kind = policy_ops.route(dtype, d)
    assert kind == ("tiled" if dtype == torch.float32 and d <= 64
                    else "pair_tile")
    assert kind in policy_ops.SYMBOLS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("metric", ["l2", "l1"])
@pytest.mark.parametrize("shape", [(3, 1000, 7, 5), (1, 256, 256, 54),
                                   (2, 333, 129, 64), (2, 300, 40, 65)],
                         ids=["ragged", "pilot", "d64", "d65"])
def test_b12_wrapper_launches_the_routed_kernel(fake_card, dtype, metric,
                                                shape):
    b, m, r, d = shape
    blocks = torch.zeros((b, m, d), dtype=dtype)
    centers = torch.zeros((b, r, d), dtype=dtype)
    out = policy_ops.policy_dist(blocks, centers, metric=metric)
    assert out.shape == (b, m, r) and out.dtype == dtype
    (name, symbol, args), = fake_card
    kind = policy_ops.route(dtype, d)
    assert (name, symbol) == ("policy_dist", policy_ops.SYMBOLS[kind] + "_"
                              + _build.SUFFIX[dtype])
    assert args[0] is blocks and args[1] is centers and args[2] is out
    assert args[3:] == (b, m, r, d, int(metric == "l1"))
    assert policy_ops.policy_dist.launches == 1
    assert policy_ops.policy_dist.tiled_launches == int(kind == "tiled")


def test_b12_grid_limit_only_for_pair_tile(fake_card):
    """The tiled kernel's persistent grid takes any number of nodes; the
    pair_tile kernel's grid z is the node count, at most 65,535."""
    many = policy_ops.MAX_GRID_YZ + 1
    policy_ops.policy_dist(torch.zeros((many, 1, 3)), torch.zeros((many, 2,
                                                                    3)))
    assert fake_card[0][1] == "policy_dist_tiled_f32"
    with pytest.raises(ValueError, match="grid"):
        policy_ops.policy_dist(torch.zeros((many, 1, 65)),
                               torch.zeros((many, 2, 65)))
    assert len(fake_card) == 1


def test_cpu_tensors_launch_nothing():
    """On CPU tensors both wrappers run their plain versions."""
    rng = np.random.default_rng(5)
    spd = torch.from_numpy(_leaves(2, 20, 5))
    blocks = torch.from_numpy(rng.standard_normal((2, 30, 6)))
    centers = torch.from_numpy(rng.standard_normal((2, 4, 6)))
    counts = (leaf_ops.leaf_factor.launches,
              policy_ops.policy_dist.launches,
              policy_ops.policy_dist.tiled_launches)
    for got, want in zip(leaf_ops.leaf_factor(spd), hck_leaf_factor_ref(spd)):
        assert torch.equal(got, want)
    for metric in ("l2", "l1"):
        assert torch.equal(
            policy_ops.policy_dist(blocks, centers, metric=metric),
            policy_dist_ref(blocks, centers, metric=metric))
    assert counts == (leaf_ops.leaf_factor.launches,
                      policy_ops.policy_dist.launches,
                      policy_ops.policy_dist.tiled_launches)
