"""B11 ``kernel_tile`` (``pairwise_kernel``): its routes, its launch, and
the tensor-core route's arithmetic.

No card is needed.  :func:`route` and :func:`core_kernel` are called on
dtypes, base kernels and widths; the wrapper's card path is followed with
the device check and the ctypes launch replaced by a recorder, which
shows the launch arguments (the TF32 planes and norms of B10's staging,
the ring, the chunks of Y, the TMA store where m % 4 == 0 and the threads'
store otherwise).  The "tc" kernel's arithmetic is emulated in float64
from the operands it reads (the TF32 hi and lo planes, three products, the
clamped norm identity, the epilogue) against the reference's
``kernel_tile`` (Pallas, interpret mode) at n = m = 256, d 54 on points of
``chip_smoke.make_data``'s distribution: within the card's 1e-5 gate,
while one TF32 pass, the control, fails it.  ``-s`` prints both errors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kernel_tile.ops import pairwise_kernel as jpairwise
from repro_torch.kernels import _build
from repro_torch.kernels.kernel_tile import ops
from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref
from repro_torch.kernels.matvec_stage.ops import tf32_split

#: the card's gate (chip_smoke.py check_tile): absolute, values in (0, 1]
ATOL = 1e-5
SMS = 132


@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrapper's card path: the device check
    passes them, the SM count is the H100's and the launch records
    (library, symbol, args)."""
    calls = []
    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, dev, *args:
                        calls.append((name, symbol, args)))
    monkeypatch.setattr(ops, "_sms", lambda dev: SMS)
    monkeypatch.setattr(ops.pairwise_kernel, "launches", 0)
    monkeypatch.setattr(ops.pairwise_kernel, "tc_launches", 0)
    return calls


def _points(seed, n, m, d):
    """make_data's distribution: x ~ N(0, (2/d) I), float32."""
    rng = np.random.default_rng(seed)
    s = np.sqrt(2.0 / d)
    return ((s * rng.standard_normal((n, d))).astype(np.float32),
            (s * rng.standard_normal((m, d))).astype(np.float32))


# ---------------------------------------------------------------------------
# the route and the launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gaussian", "imq", "laplace"])
@pytest.mark.parametrize("d", [1, 8, 54, 64, 65, 90])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_route_by_dtype_kernel_and_width(dtype, d, name):
    got = ops.route(dtype, name, d)
    want = ("tc" if dtype == torch.float32 and name != "laplace" and d <= 64
            else "cuda_core")
    assert got == want
    assert ops.core_kernel(d) == ("tiled" if d <= 64 else "pair_tile")


@pytest.mark.parametrize("m", [3000, 3001], ids=["m%4==0", "m%4!=0"])
@pytest.mark.parametrize("name", ["gaussian", "imq"])
def test_tc_launch_arguments(fake_card, name, m):
    x, y = map(torch.from_numpy, _points(0, 4097, m, 55))
    out = ops.pairwise_kernel(x, y, name=name, sigma=1.5)
    assert out.shape == (4097, m) and out.dtype == torch.float32
    ((lib, sym, args),) = fake_card
    assert (lib, sym) == ("kernel_tile", "kernel_tile_tc_f32")
    xs, ys, xn, yn, o, n_, m_, dp, kind, sigma, stages, chunks, tma = args
    assert (n_, m_, dp, sigma) == (4097, m, 56, 1.5)
    assert kind == _build.EPILOGUE_KIND[name]
    assert o is out
    assert xs.shape == (2, 4097, 56) and ys.shape == (2, m, 56)
    assert not xs[:, :, 55:].any() and not ys[:, :, 55:].any()
    assert torch.equal(xs[0, :, :55], tf32_split(x)[0])
    torch.testing.assert_close(xn, (x * x).sum(1), rtol=0, atol=0)
    assert yn.shape == (-(-m // 128) * 128,) and not yn[m:].any()
    # two boxes a row leave room for two Y stages beside the staging
    assert stages == ops.tc_stages(56) == 2
    assert ops.tc_smem(56, 2) <= _build.SMEM_MAX < ops.tc_smem(56, 3)
    # 33 row blocks on 132 SMs: Y split in 4 ranges of its 24 tiles
    assert chunks == ops.tc_chunks(4097, m, SMS) == 4
    assert tma == int(m % 4 == 0)
    assert (ops.pairwise_kernel.launches,
            ops.pairwise_kernel.tc_launches) == (1, 1)


def test_tc_plan_shapes():
    # the covtype-width tile: 128 row blocks fill the card, no split
    assert ops.tc_plan(16384, 16384, 54, SMS) == {
        "dp": 56, "stages": 2, "chunks": 1, "tma_out": 1}
    # one box a row: the deepest ring
    assert ops.tc_plan(256, 16, 4, SMS) == {
        "dp": 8, "stages": 4, "chunks": 1, "tma_out": 1}
    assert ops.tc_chunks(128, 100, SMS) == 1        # one tile of Y
    assert ops.tc_chunks(128, 128 * 500, SMS) == SMS


def test_y_is_x_stages_the_planes_once(fake_card):
    x = torch.from_numpy(_points(1, 300, 1, 54)[0])
    ops.pairwise_kernel(x, x)
    ((_, _, args),) = fake_card
    assert args[0] is args[1]                          # xs is ys
    assert args[5] == args[6] == 300


@pytest.mark.parametrize("name,d,sym", [
    ("laplace", 54, "kernel_tile_tiled_f32"),
    ("laplace", 90, "kernel_tile_f32"),
    ("gaussian", 90, "kernel_tile_f32"),
    ("imq", 65, "kernel_tile_f32")])
def test_cuda_core_launch_arguments(fake_card, name, d, sym):
    x, y = map(torch.from_numpy, _points(2, 70, 33, d))
    out = ops.pairwise_kernel(x.double(), y, name=name, sigma=0.5)
    ((lib, got_sym, args),) = fake_card
    assert (lib, got_sym) == ("kernel_tile", sym)
    assert args[0].dtype == torch.float32                 # cast first
    assert args[2] is out and args[3:] == (70, 33, d,
                                           _build.EPILOGUE_KIND[name], 0.5)
    assert (ops.pairwise_kernel.launches,
            ops.pairwise_kernel.tc_launches) == (1, 0)


@pytest.mark.parametrize("name", ["gaussian", "imq"])
def test_tiled_kernel_takes_laplace_only(fake_card, name):
    x, y = map(torch.from_numpy, _points(6, 70, 33, 54))
    out = torch.empty((70, 33))
    with pytest.raises(ValueError, match="laplace only"):
        ops.launch_kernel("tiled", x, y, out, name=name, sigma=1.0)
    assert not fake_card and ops.pairwise_kernel.launches == 0


def test_cpu_tensors_run_the_plain_version(f64):
    x, y = map(torch.from_numpy, _points(3, 130, 129, 54))
    before = ops.pairwise_kernel.launches
    for name in ("gaussian", "imq", "laplace"):
        got = ops.pairwise_kernel(x, y, name=name)
        want = jpairwise(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                         name=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        torch.testing.assert_close(got, pairwise_kernel_ref(x, y, name=name))
    assert ops.pairwise_kernel.launches == before


# ---------------------------------------------------------------------------
# the "tc" arithmetic, emulated in float64
# ---------------------------------------------------------------------------

def _emulate_tc(x, y, name, sigma, passes):
    """The tensor-core kernel from the wrapper's staging: S from the TF32
    hi and lo planes (three products, or the control's one), d2 =
    max(|x|^2 + |y|^2 - 2 S, 0) with the float32 norms, the epilogue, the
    value rounded to float32."""
    from repro_torch.kernels.matvec_stage.ops import prepare_pairs

    st = prepare_pairs(*map(torch.from_numpy, (x, y)))
    xs, ys = st["xs"].double(), st["ys"].double()
    s = xs[0] @ ys[0].T
    if passes == 3:
        s = xs[1] @ ys[0].T + xs[0] @ ys[1].T + s
    xn = st["xn"].double()
    yn = st["yn"].double()[:y.shape[0]]
    d2 = torch.clamp(xn[:, None] + yn[None, :] - 2.0 * s, min=0.0)
    kv = (torch.exp(-d2 / (2 * sigma ** 2)) if name == "gaussian"
          else sigma / torch.sqrt(d2 + sigma ** 2))
    return kv.float().numpy()


@pytest.mark.parametrize("name", ["gaussian", "imq"])
def test_tc_arithmetic_matches_reference(f64, name):
    x, y = _points(4, 256, 256, 54)
    want = np.asarray(jpairwise(jnp.asarray(x), jnp.asarray(y), name=name))
    assert want.dtype == np.float32
    three = float(np.abs(_emulate_tc(x, y, name, 1.0, 3) - want).max())
    one = float(np.abs(_emulate_tc(x, y, name, 1.0, 1) - want).max())
    print(f"\n[B11 tc, {name}, 256 x 256, d 54] three TF32 passes "
          f"max|d| {three:.3e} (gate {ATOL}); one pass (control) "
          f"{one:.3e}")
    assert three <= ATOL
    assert one > ATOL, "one TF32 pass must fail the gate"


@pytest.mark.parametrize("n,m,d", [
    (256, 16, 4), (128, 128, 64),        # the autotune sweep's two shapes
    (128, 96, 7), (128, 96, 16), (128, 96, 23), (128, 96, 32),
    (128, 96, 39), (128, 96, 48)])       # with 54, every k-step count
def test_tc_arithmetic_at_each_k_step_count(f64, n, m, d):
    x, y = _points(7, n, m, d)
    want = np.asarray(jpairwise(jnp.asarray(x), jnp.asarray(y)))
    got = _emulate_tc(x, y, "gaussian", 1.0, 3)
    assert got.shape == (n, m)
    assert float(np.abs(got - want).max()) <= ATOL


def test_tc_arithmetic_diagonal_of_k_x_x(f64):
    x, _ = _points(5, 256, 1, 54)
    k = _emulate_tc(x, x, "gaussian", 1.0, 3)
    assert float(np.abs(np.diag(k) - 1).max()) <= ATOL


def test_every_header_feeds_the_build_digest():
    # an edited header (tc_pairs.cuh, shared with B10; dist_tiled.cuh,
    # shared with B12) must change every library's digest
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert {"tc_pairs.cuh", "dist_tiled.cuh"} <= headers
    assert headers == set(_build._HEADERS)
