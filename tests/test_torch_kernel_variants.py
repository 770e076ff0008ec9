"""Which kernel a wrapper launches: B14's three kernels of
``csrc/flash_attention.cu`` (the Hopper ``wgmma`` kernel, the ``mma.sync``
kernel, the float32 CUDA-core kernel) and B6's two load paths (16-byte and
scalar), each chosen by a pure function of the dtype, the shape and the
base addresses before the launch.

No card is needed: the choice functions are called on CPU tensors and
their addresses, and the wrappers' card path is followed with the device
check and the ctypes launch replaced by stand-ins that record what would
be launched.  On CPU tensors both wrappers run their plain versions
(checked against the JAX reference at a small shape) and launch nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.hck_leaf.ops import leaf_project as jleaf_project
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.hck_leaf import ops as leaf_ops
from repro_torch.kernels.hck_leaf.ref import hck_leaf_project_ref


def _view(shape, dtype, offset):
    """A contiguous tensor of ``shape`` that starts ``offset`` elements
    into a fresh buffer (offset 1: not 16-byte aligned)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def _qkv(dtype, d, offset, hkv):
    return (_view((1, 4, 8, d), dtype, offset),
            _view((1, hkv, 8, d), dtype, offset),
            _view((1, hkv, 8, d), dtype, offset))


@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrappers' card path: the device check
    passes them (the CPU stands in for the card, so outputs can be
    allocated) and the launch records (library, symbol, args)."""
    calls = []
    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, dev, *args:
                        calls.append((name, symbol, args)))
    for fn, attrs in ((fa_ops.flash_attention, ("launches",
                                                "wgmma_launches")),
                      (leaf_ops.leaf_project, ("launches",))):
        for attr in attrs:
            monkeypatch.setattr(fn, attr, 0)
    return calls


# ---------------------------------------------------------------------------
# B14: wgmma for aligned bfloat16 with D % 8 == 0, mma.sync for the other
# bfloat16 inputs, the CUDA-core kernel for float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hkv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "view+1"])
@pytest.mark.parametrize("d", [16, 20, 72, 112, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_b14_variant(dtype, d, offset, hkv):
    q, k, v = _qkv(dtype, d, offset, hkv)
    got = fa_ops.variant(dtype, d, q.data_ptr(), k.data_ptr(), v.data_ptr())
    if dtype == torch.float32:
        want = "f32"
    elif d % 8 == 0 and offset == 0:
        want = "wgmma"
    else:
        want = "mma"
    assert got == want
    assert got in fa_ops.SYMBOLS


def test_b14_variant_needs_every_base_aligned():
    """One misaligned operand (here v) is enough to leave TMA out."""
    assert fa_ops.variant(torch.bfloat16, 112, 0, 16, 32) == "wgmma"
    assert fa_ops.variant(torch.bfloat16, 112, 0, 16, 34) == "mma"
    assert fa_ops.variant(torch.bfloat16, 112, 0, 8, 32) == "mma"


@pytest.mark.parametrize("dtype, d, offset, kind", [
    (torch.bfloat16, 112, 0, "wgmma"),
    (torch.bfloat16, 112, 1, "mma"),
    (torch.bfloat16, 20, 0, "mma"),
    (torch.float32, 112, 0, "f32"),
])
def test_b14_wrapper_launches_the_chosen_kernel(fake_card, dtype, d, offset,
                                                kind):
    q, k, v = _qkv(dtype, d, offset, 2)
    out = fa_ops.flash_attention(q, k, v, causal=False)
    assert [(c[0], c[1]) for c in fake_card] == [("flash_attention",
                                                  fa_ops.SYMBOLS[kind])]
    args = fake_card[0][2]
    assert args[3] is out and args[4:] == (1, 4, 2, 8, d, 0, 1.0 / d ** 0.5)
    assert fa_ops.flash_attention.launches == 1
    assert fa_ops.flash_attention.wgmma_launches == int(kind == "wgmma")


def test_b14_checks_come_before_the_choice(fake_card):
    """Windows and wide heads raise before any kernel is chosen."""
    q, k, v = _qkv(torch.bfloat16, 112, 0, 4)
    with pytest.raises(NotImplementedError, match="sliding windows"):
        fa_ops.flash_attention(q, k, v, window=4)
    wide = _view((1, 2, 8, 136), torch.bfloat16, 0)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(wide, wide, wide)
    assert fake_card == [] and fa_ops.flash_attention.launches == 0


# ---------------------------------------------------------------------------
# B6: 16-byte loads where r is a multiple of the vector width and u is
# 16-byte aligned, else the scalar path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r, dtype, offset, width", [
    (128, torch.float32, 0, 4),
    (128, torch.float32, 1, 1),
    (130, torch.float32, 0, 1),
    (4, torch.float32, 0, 4),
    (9, torch.float32, 0, 1),
    (128, torch.float64, 0, 2),
    (128, torch.float64, 1, 1),
    (130, torch.float64, 0, 2),
    (9, torch.float64, 0, 1),
    (1, torch.float64, 0, 1),
])
def test_b6_load_width(r, dtype, offset, width):
    u = _view((3, 5, r), dtype, offset)
    assert leaf_ops.load_width(r, u.element_size(), u.data_ptr()) == width


@pytest.mark.parametrize("r, offset, width", [(128, 0, 4), (128, 1, 1),
                                              (9, 0, 1)])
def test_b6_wrapper_passes_the_chosen_width(fake_card, r, offset, width):
    u = _view((3, 5, r), torch.float32, offset)
    b = _view((3, 5, 7), torch.float32, 0)
    c = leaf_ops.leaf_project(u, b)
    assert c.shape == (3, r, 7)
    (name, symbol, args), = fake_card
    assert (name, symbol) == ("hck_leaf_project", "hck_leaf_project_f32")
    assert args[3:] == (3, 5, r, 7, width)
    assert leaf_ops.leaf_project.launches == 1


# ---------------------------------------------------------------------------
# CPU tensors: the plain versions, no launch
# ---------------------------------------------------------------------------

def test_wrappers_on_cpu_run_plain_versions_and_launch_nothing(monkeypatch):
    for fn, attrs in ((fa_ops.flash_attention, ("launches",
                                                "wgmma_launches")),
                      (leaf_ops.leaf_project, ("launches",))):
        for attr in attrs:
            monkeypatch.setattr(fn, attr, 0)
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    got = fa_ops.flash_attention(*map(torch.from_numpy, (q, k, v)))
    torch.testing.assert_close(
        got, attention_ref(*map(torch.from_numpy, (q, k, v))), rtol=0,
        atol=0)
    want = np.asarray(jattention_ref(*map(jnp.asarray, (q, k, v)),
                                     causal=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    u = rng.standard_normal((4, 16, 8)).astype(np.float32)
    b = rng.standard_normal((4, 16, 3)).astype(np.float32)
    c = leaf_ops.leaf_project(torch.from_numpy(u), torch.from_numpy(b))
    torch.testing.assert_close(
        c, hck_leaf_project_ref(torch.from_numpy(u), torch.from_numpy(b)),
        rtol=0, atol=0)
    jc = np.asarray(jleaf_project(jnp.asarray(u), jnp.asarray(b),
                                  interpret=True))
    # float32 sums of 16 terms in two orders
    np.testing.assert_allclose(c.numpy(), jc, rtol=0,
                               atol=1e-5 * np.abs(jc).max())
    assert fa_ops.flash_attention.launches == 0
    assert fa_ops.flash_attention.wgmma_launches == 0
    assert leaf_ops.leaf_project.launches == 0
