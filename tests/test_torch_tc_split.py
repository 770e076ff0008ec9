"""Split TF32 on the tensor cores: B10 (``kernel_matvec``, its "tc" route)
and B15 (``ssd_intra_chunk``).

No card is needed.  The tests check which kernel B10's wrapper chooses
and launches (the launch replaced by a recorder), the wrapper's staging of
the tensor-core kernel's inputs (zero padding, the hi/lo split, the norms,
the permutation of V's rows), and the arithmetic of both kernels, emulated
on the CPU in float64 from TF32-rounded operands exactly as the kernels
combine them (three passes: hi hi + hi lo + lo hi; V's and X's rows read in
the fragment order of ``csrc/tf32x3.cuh``), against the JAX reference:
within the kernels' gates (B10 2e-6 of max K|V|, B15 1e-5 of the
componentwise magnitude), while one TF32 pass, the control, fails them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matvec_stage.ref import kernel_matvec_ref as jmatvec_ref
from repro.kernels.ssd_chunk.ssd_chunk import ssd_intra_chunk as jssd_intra
from repro_torch.kernels import _build
from repro_torch.kernels.matvec_stage import ops as mv_ops
from repro_torch.kernels.matvec_stage.ref import kernel_matvec_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops

#: the kernels' gates (chip_smoke.py: FULL_RTOL, B15_RTOL)
B10_RTOL, B15_RTOL = 2e-6, 1e-5


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
    monkeypatch.setattr(mv_ops.kernel_matvec, "launches", 0)
    monkeypatch.setattr(mv_ops.kernel_matvec, "tc_launches", 0)
    monkeypatch.setattr(ssd_ops.ssd_intra_chunk, "launches", 0)
    monkeypatch.setattr(ssd_ops.ssd_intra_chunk, "wgmma_launches", 0)
    return calls


def _points(seed, b, m, d, k, dtype=np.float32):
    """make_data's distribution: x ~ N(0, (2/d) I), V ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(2.0 / d)
    return ((s * rng.standard_normal((b, d))).astype(dtype),
            (s * rng.standard_normal((m, d))).astype(dtype),
            rng.standard_normal((m, k)).astype(dtype))


# ---------------------------------------------------------------------------
# B10: the route and the launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gaussian", "imq", "laplace"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("d", [1, 54, 64, 65, 780])
def test_b10_route(dtype, name, d):
    want = ("tc" if dtype == torch.float32 and name != "laplace" and d <= 64
            else "cuda_core")
    assert mv_ops.route(dtype, name, d) == want


@pytest.mark.parametrize("dtype, name, d, symbol", [
    (torch.float32, "gaussian", 54, "kernel_matvec_tc_f32"),
    (torch.float32, "imq", 55, "kernel_matvec_tc_f32"),
    (torch.float32, "laplace", 54, "kernel_matvec_f32"),
    (torch.float64, "gaussian", 54, "kernel_matvec_f64"),
    (torch.float32, "gaussian", 90, "kernel_matvec_f32"),
])
def test_b10_wrapper_launches_the_chosen_kernel(fake_card, dtype, name, d,
                                                symbol):
    b, m, k = 37, 29, 7
    xc, y, v = (torch.zeros(s, dtype=dtype) for s in ((b, d), (m, d),
                                                       (m, k)))
    z = mv_ops.kernel_matvec(xc, y, v, name=name, sigma=0.5)
    assert z.shape == (b, k) and z.dtype == dtype
    (lib, sym, args), = fake_card
    assert (lib, sym) == ("kernel_matvec", symbol)
    tc = symbol.endswith("tc_f32")
    assert mv_ops.kernel_matvec.launches == 1
    assert mv_ops.kernel_matvec.tc_launches == int(tc)
    if tc:
        dp = -(-d // 8) * 8
        # xs, ys, vt, xn, yn, z, then the shape, the group, the kind
        assert args[5].data_ptr() == z.data_ptr()
        assert args[6:] == (b, m, dp, 8, 32, 0, k, 8, k,
                            _build.EPILOGUE_KIND[name], 0.5,
                            mv_ops.tc_stages(dp, 8))
        assert tuple(args[0].shape) == (2, b, dp)
        assert tuple(args[2].shape) == (2, 8, 32)
    else:
        assert args[4:] == (b, m, d, k, k, _build.EPILOGUE_KIND[name], 0.5)


def test_b10_wide_k_goes_in_column_groups(fake_card):
    """k = 160: five launches of 32 columns, each writing its own slice of
    z; k = 1 and k = 16 one launch each (wgmma N 8 and 16)."""
    x = torch.zeros((40, 54))
    z = mv_ops.kernel_matvec(x, x, torch.zeros((40, 160)))
    assert [a[11:14] for _, _, a in fake_card] == [
        (c0, 32, 32) for c0 in range(0, 160, 32)]
    assert [a[5].data_ptr() for _, _, a in fake_card] == [
        z[:, c0:].data_ptr() for c0 in range(0, 160, 32)]
    assert mv_ops.kernel_matvec.tc_launches == 5
    assert mv_ops.tc_groups(1) == [(0, 1, 8)]
    assert mv_ops.tc_groups(16) == [(0, 16, 16)]
    assert mv_ops.tc_groups(20) == [(0, 20, 32)]
    assert mv_ops.tc_groups(7) == [(0, 7, 8)]


def test_b10_tc_rings_fit_the_block():
    """Every group width at the widest resident rows keeps a ring of at
    least one stage inside 227 KB; the covtype shape keeps two."""
    for dp in (8, 32, 56, 64):
        for kp in (8, 16, 32):
            st = mv_ops.tc_stages(dp, kp)
            assert 1 <= st <= mv_ops.TC_MAX_STAGES
            assert mv_ops.tc_smem(dp, kp, st) <= _build.SMEM_MAX
            if st < mv_ops.TC_MAX_STAGES:
                assert mv_ops.tc_smem(dp, kp, st + 1) > _build.SMEM_MAX
    assert mv_ops.tc_stages(56, 8) == 2 and mv_ops.tc_stages(56, 16) == 2
    assert {"hopper.cuh", "tf32x3.cuh"} <= set(_build._HEADERS)


# ---------------------------------------------------------------------------
# B10: the wrapper's staging
# ---------------------------------------------------------------------------

def _rna_reference(a):
    """tf32 rounding from the definition: the nearest value with 10
    mantissa bits, ties away from zero (numpy, float64 arithmetic)."""
    a = np.asarray(a, np.float64)
    m, e = np.frexp(a)                       # a = m 2^e, 0.5 <= |m| < 1
    scaled = np.abs(m) * 2.0 ** 11           # 11 significant bits
    r = np.floor(scaled + 0.5)               # ties away (on the magnitude)
    return (np.sign(m) * r * 2.0 ** (e - 11)).astype(np.float32)


def test_tf32_split():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.standard_normal(4000) * 10.0 ** rng.integers(
        -6, 6, 4000), [0.0, 1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                       1.0 + 3 * 2.0 ** -12]]).astype(np.float32)
    hi, lo = mv_ops.tf32_split(torch.from_numpy(a))
    bits = lambda t: t.numpy().view(np.uint32)
    # hi and lo keep 10 mantissa bits: their low 13 bits are 0
    assert not (bits(hi) & 0x1FFF).any() and not (bits(lo) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy(), _rna_reference(a))
    # ties round away from zero
    assert hi[-3] == 1.0 + 2.0 ** -10 and hi[-2] == -(1.0 + 2.0 ** -10)
    assert hi[-1] == 1.0 + 2.0 ** -10
    rec = hi.double() + lo.double()
    assert float(((rec - torch.from_numpy(a).double()).abs()
                  / torch.from_numpy(a).double().abs().clamp_min(1e-30))
                 .max()) <= 2.0 ** -21
    # hi alone keeps 11 significant bits, not float32's 24
    nz = a != 0
    assert float(np.max(np.abs(hi.numpy()[nz].astype(np.float64) - a[nz])
                        / np.abs(a[nz]))) > 2.0 ** -13


def _unpermute_keys(v):
    """The inverse of mv_ops.permute_keys."""
    m, k = v.shape
    inv = [mv_ops.KEY_OF.index(p) for p in range(8)]
    return v.reshape(m // 8, 8, k)[:, inv, :].reshape(m, k)


def test_permute_keys_round_trip():
    v = torch.arange(48.0).reshape(24, 2)
    p = mv_ops.permute_keys(v)
    assert p[:8, 0].tolist() == [0.0, 4.0, 8.0, 12.0, 2.0, 6.0, 10.0, 14.0]
    assert torch.equal(_unpermute_keys(p), v)
    assert sorted(mv_ops.KEY_OF) == list(range(8))
    # the same order is written in the kernels' shared header
    header = (_build.CSRC / "tf32x3.cuh").read_text()
    assert "(0, 2, 4, 6, 1, 3, 5, 7)" in header
    assert tuple(mv_ops.KEY_OF) == (0, 2, 4, 6, 1, 3, 5, 7)


@pytest.mark.parametrize("same", [True, False], ids=["K(X,X)", "K(X,Y)"])
def test_prepare_tc_stages_the_kernel_inputs(same):
    x, y, _ = map(torch.from_numpy, _points(1, 21, 13, 55, 3))
    y = x if same else y
    m = y.shape[0]
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (m, 3)).astype(np.float32))
    st = mv_ops.prepare_tc(x, y, v)
    assert (st["dp"], st["kp"], st["mp"]) == (56, 8, -(-m // 8) * 8)
    for planes, pts in ((st["xs"], x), (st["ys"], y)):
        assert planes.shape == (2, pts.shape[0], 56)
        assert not planes[:, :, 55:].any()                # d padded with 0
        hi, lo = planes
        assert torch.equal(hi[:, :55], mv_ops.tf32_split(pts)[0])
        assert float((hi + lo - torch.nn.functional.pad(pts, (0, 1)))
                     .abs().max()) <= 2.0 ** -21 * float(pts.abs().max())
    if same:
        assert st["ys"] is st["xs"]
    torch.testing.assert_close(st["xn"], (x * x).sum(1), rtol=0, atol=0)
    assert st["yn"].shape == (128,) and not st["yn"][m:].any()
    torch.testing.assert_close(st["yn"][:m], (y * y).sum(1), rtol=0, atol=0)
    vt = st["vt"]
    assert vt.shape == (2, 8, st["mp"]) and vt.is_contiguous()
    back = _unpermute_keys((vt[0] + vt[1]).T.contiguous())
    assert not back[m:].any() and not back[:, 3:].any()
    assert float((back[:m, :3] - v).abs().max()) <= 2.0 ** -21 * float(
        v.abs().max())


# ---------------------------------------------------------------------------
# The arithmetic, emulated in float64 from TF32 operands
# ---------------------------------------------------------------------------

def _split_reg(a):
    """A split in registers, as csrc/tf32x3.cuh's ``split`` makes it, of a
    float64 array's float32 values: hi rounded to nearest (ties away), lo =
    a - hi with the low 13 bits that the tensor core drops as it reads a
    TF32 operand cleared (rounding toward zero).  As float64."""
    a32 = torch.as_tensor(a, dtype=torch.float32)
    hi = mv_ops.tf32_split(a32)[0]
    lo = ((a32 - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi.double().numpy(), lo.double().numpy()


def _prod(a, b, passes):
    """a @ b from TF32 operands split in registers, in float64: three
    passes (lo hi + hi lo + hi hi) or, the control, one (hi hi)."""
    ah, al = _split_reg(a)
    bh, bl = _split_reg(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _emulate_b10(x, y, v, name, sigma, passes):
    """B10's tensor-core kernel from the wrapper's staged inputs: S from
    the hi and lo planes, d2 = max(|x|^2 + |y|^2 - 2 S, 0), the kernel
    value split in registers as the epilogue splits it, and K V against
    the staged V^T
    with K's columns in the fragment order (logical column p of each group
    of 8 is real column KEY_OF[p])."""
    st = mv_ops.prepare_tc(*map(torch.from_numpy, (x, y, v)))
    xs, ys = st["xs"].double().numpy(), st["ys"].double().numpy()
    if passes == 1:
        s = xs[0] @ ys[0].T
    else:
        s = xs[1] @ ys[0].T + xs[0] @ ys[1].T + xs[0] @ ys[0].T
    m, mp = y.shape[0], st["mp"]
    xn = st["xn"].double().numpy()
    yn = st["yn"].double().numpy()[:m]
    d2 = np.maximum(xn[:, None] + yn[None, :] - 2.0 * s, 0.0)
    kv = (np.exp(-d2 / (2 * sigma ** 2)) if name == "gaussian"
          else sigma / np.sqrt(d2 + sigma ** 2)).astype(np.float32)
    kfull = np.zeros((x.shape[0], mp), np.float32)
    kfull[:, :m] = kv
    # logical column 8 j + p holds real column 8 j + KEY_OF[p]
    klog = mv_ops.permute_keys(torch.from_numpy(kfull.T.copy())).numpy().T
    vt = st["vt"].double().numpy()                          # (2, kp, mp)
    kh, kl = _split_reg(klog)
    if passes == 1:
        out = kh @ vt[0].T
    else:
        out = kl @ vt[0].T + kh @ vt[1].T + kh @ vt[0].T
    return out[:, :v.shape[1]]


@pytest.mark.parametrize("name", ["gaussian", "imq"])
def test_b10_split_tf32_meets_the_gate_one_pass_does_not(f64, name):
    """At make_data's distribution, d 54, k 7, sigma 1 (the covtype
    check's, at n = 2,048): three passes within 2e-6 of max K|V| of the
    JAX reference in float64; one pass above it."""
    x, y, v = _points(2, 2048, 2048, 54, 7)
    want = np.asarray(jmatvec_ref(jnp.asarray(x, jnp.float64),
                                  jnp.asarray(y, jnp.float64),
                                  jnp.asarray(v, jnp.float64), name=name,
                                  sigma=1.0))
    assert want.dtype == np.float64
    scale = np.abs(np.asarray(jmatvec_ref(
        jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
        jnp.abs(jnp.asarray(v, jnp.float64)), name=name, sigma=1.0))).max()
    three = np.abs(_emulate_b10(x, y, v, name, 1.0, 3) - want).max() / scale
    one = np.abs(_emulate_b10(x, y, v, name, 1.0, 1) - want).max() / scale
    print(f"B10 {name} emulated, max |z - z_ref| / max K|V|: three passes "
          f"{three:.2e}, one pass {one:.2e} (gate {B10_RTOL})")
    assert three <= B10_RTOL / 10, three
    assert one > B10_RTOL, one
    # the port's plain version agrees with the reference too (f32 route)
    plain = kernel_matvec_ref(*map(torch.from_numpy, (x, y, v)), name=name)
    assert np.abs(plain.double().numpy() - want).max() / scale <= B10_RTOL


def _ssd_inputs(seed, bh, nc, q, n, p):
    """chip_smoke.ssd_inputs' distribution: c, b, xdt ~ N(0, 1), cs the
    within-chunk cumulative sum of steps -U(0, 1.5)."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((bh, nc, q, n)).astype(np.float32)
    b = rng.standard_normal((bh, nc, q, n)).astype(np.float32)
    xdt = rng.standard_normal((bh, nc, q, p)).astype(np.float32)
    cs = np.cumsum(-1.5 * rng.uniform(size=(bh, nc, q)), -1).astype(
        np.float32)
    return c, b, xdt, cs


def _ssd_l(cs):
    q = cs.shape[-1]
    csd = cs.astype(np.float64)
    diff = csd[..., :, None] - csd[..., None, :]
    mask = np.tril(np.ones((q, q), bool))
    return np.where(mask, np.exp(np.where(mask, diff, 0.0)), 0.0)


def _emulate_b15(c, b, xdt, cs, passes):
    """B15's kernel: S = C B^T from split operands, S L in float32, split
    again as the A fragment of (S L) X, whose keys the kernel reads in the
    fragment order (logical key p of each group of 8 is real key
    KEY_OF[p], X's rows read to match)."""
    q = c.shape[2]
    qp = -(-q // 8) * 8
    s = _prod(c, np.swapaxes(b, -1, -2), passes)
    sl = (s * _ssd_l(cs)).astype(np.float32)
    order = np.concatenate([8 * j + np.asarray(mv_ops.KEY_OF)
                            for j in range(qp // 8)])
    pad = ((0, 0), (0, 0), (0, 0), (0, qp - q))
    sl = np.pad(sl, pad)[..., order]
    xp = np.pad(xdt, ((0, 0), (0, 0), (0, qp - q), (0, 0)))[..., order, :]
    return _prod(sl, xp, passes)


@pytest.mark.parametrize("shape", [(2, 2, 256, 64, 64), (3, 1, 100, 61, 43)],
                         ids=["model", "ragged"])
def test_b15_split_tf32_meets_the_gate_one_pass_does_not(shape):
    """The prefill's chunk (Q 256, N = P = 64) and a ragged one: three
    passes within 1e-5 of the componentwise magnitude of the exact value
    and of the JAX Pallas kernel (interpret mode, float32); one pass above
    it."""
    c, b, xdt, cs = _ssd_inputs(3, *shape)
    l_mat = _ssd_l(cs)
    cd, bd, xd = (a.astype(np.float64) for a in (c, b, xdt))
    exact = ((cd @ np.swapaxes(bd, -1, -2)) * l_mat) @ xd
    mag = (((np.abs(cd) @ np.swapaxes(np.abs(bd), -1, -2)) * l_mat)
           @ np.abs(xd)).max()
    pallas = np.asarray(jssd_intra(*map(jnp.asarray, (c, b, xdt, cs)),
                                   interpret=True))
    assert pallas.dtype == np.float32
    three = _emulate_b15(c, b, xdt, cs, 3)
    one = _emulate_b15(c, b, xdt, cs, 1)
    print(f"B15 {shape} emulated, max |y - y_exact| / magnitude: three "
          f"passes {np.abs(three - exact).max() / mag:.2e}, one pass "
          f"{np.abs(one - exact).max() / mag:.2e} (gate {B15_RTOL})")
    assert np.abs(three - exact).max() / mag <= B15_RTOL / 10
    assert np.abs(three - pallas).max() / mag <= B15_RTOL
    assert np.abs(one - exact).max() / mag > B15_RTOL


def test_b15_wrapper_launch(fake_card):
    c, b, xdt, cs = map(torch.from_numpy, _ssd_inputs(4, 2, 3, 99, 61, 43))
    y = ssd_ops.ssd_intra_chunk(c, b, xdt, cs)
    (lib, sym, args), = fake_card
    assert (lib, sym) == ("ssd_chunk", "ssd_intra_chunk_f32")   # mma.sync
    assert args[4] is y and args[5:] == (6, 99, 61, 43)
    assert ssd_ops.ssd_intra_chunk.launches == 1


@pytest.mark.parametrize("n, p, offset, kind", [
    (64, 64, 0, "wgmma"), (16, 24, 0, "wgmma"), (60, 44, 0, "wgmma"),
    (4, 4, 0, "wgmma"), (64, 64, 1, "mma"), (61, 43, 0, "mma"),
    (128, 128, 0, "mma"), (64, 68, 0, "mma"), (0, 8, 0, "mma"),
])
def test_b15_variant(n, p, offset, kind):
    """wgmma where N and P are multiples of 4 up to 64 and the bases are
    16-byte aligned (TMA's rows), mma.sync otherwise."""
    base = 4096 + 4 * offset
    assert ssd_ops.variant(n, p, base, base + 1024, base + 2048) == kind
    assert kind in ssd_ops.SYMBOLS
    assert ssd_ops.variant(64, 64, 0, 16, 36) == "mma"     # one misaligned


@pytest.mark.parametrize("shape, offset, kind", [
    ((2, 3, 130, 60, 44), 0, "wgmma"), ((2, 3, 130, 60, 44), 1, "mma"),
    ((2, 1, 64, 128, 64), 0, "mma"),
])
def test_b15_wrapper_launches_the_chosen_kernel(fake_card, shape, offset,
                                               kind):
    bh, nc, q, n, p = shape
    c, b, xdt = (torch.zeros(int(np.prod(s)) + offset)[offset:].view(s)
                 for s in ((bh, nc, q, n), (bh, nc, q, n), (bh, nc, q, p)))
    y = ssd_ops.ssd_intra_chunk(c, b, xdt, torch.zeros((bh, nc, q)))
    (lib, sym, args), = fake_card
    assert (lib, sym) == ("ssd_chunk", ssd_ops.SYMBOLS[kind])
    assert args[4] is y and args[5:] == (bh * nc, q, n, p)
    assert ssd_ops.ssd_intra_chunk.launches == 1
    assert ssd_ops.ssd_intra_chunk.wgmma_launches == int(kind == "wgmma")
