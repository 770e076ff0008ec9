"""Port parity: the LM serving path's stages and modules below the model,
``attention`` (B14) and ``ssd_intra_chunk`` (B15), the SSM scan and the
HCK decode attention, against the JAX reference.

The same numpy-seeded float32 inputs go through both packages; the
reference's Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them.  Every dtype is pinned (float32
arrays, int32 tokens), since another test may have left JAX's x64 mode on.
Tolerances are relative to the largest entry of the reference's output;
what separates the packages is float32 summation order (and, for the HCK
state, an 8 x 8 inverse of a jittered Gram).  The CUDA kernels run only on
the card, where chip_smoke.py holds them against these plain versions.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as jflash_attention)
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.ssd_chunk.ref import ssd_intra_chunk_ref as jssd_ref
from repro.kernels.ssd_chunk.ssd_chunk import (
    ssd_intra_chunk as jssd_intra_chunk)
from repro.models import attention_backends as jab
from repro.models import ssm as jssm
from repro_torch.kernels import _build, registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref
from repro_torch.models import attention_backends as ab
from repro_torch.models import ssm

F32 = np.float32


def _close(got, want, rtol):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, err


def _qkv(seed, b=2, hq=4, hkv=2, s=128, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(F32)
                 for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))


# ---------------------------------------------------------------------------
# B14: the attention stage's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_attention_stage_matches_reference_and_pallas(causal):
    q, k, v = _qkv(0)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(got, jattention_ref(jq, jk, jv, causal=causal), 1e-5)
    _close(got, jflash_attention(jq, jk, jv, causal=causal, interpret=True),
           1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_stage_ragged_matches_reference(causal):
    """A ragged S (the Pallas kernel asserts S % bq == 0; the CUDA kernel
    masks the tail) against the reference's dense oracle."""
    q, k, v = _qkv(1, s=100)
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    _close(got, jattention_ref(*map(jnp.asarray, (q, k, v)), causal=causal),
           1e-5)


@pytest.mark.parametrize("window", [0, 64])
def test_chunked_attention_matches_reference(window):
    q, k, v = _qkv(2)
    got = ab.chunked_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                               window=window)
    want = jab.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=window, block=64)
    _close(got, want, 1e-5)
    _close(ab.dense_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window), want, 1e-5)


def test_attention_wrapper_runs_plain_on_cpu_and_counts():
    q, k, v = map(torch.from_numpy, _qkv(3, s=64))
    launches, calls = fa_ops.flash_attention.launches, attention_ref.calls
    got = fa_ops.flash_attention(q, k, v)
    assert fa_ops.flash_attention.launches == launches
    assert attention_ref.calls == calls + 1
    torch.testing.assert_close(got, attention_ref(q, k, v), rtol=0, atol=0)
    impl = registry.get_impl("attention", "cuda")
    assert impl is not None and registry.get_impl("attention", "torch")
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa_ops.flash_attention(q[:, :3], k, v)


def _on_card(shape, dtype):
    """A stand-in for a CUDA tensor: the wrappers' checks read only these
    attributes before the launch."""
    return types.SimpleNamespace(
        device=torch.device("cuda", 0), dtype=dtype, shape=torch.Size(shape),
        ndim=len(shape), requires_grad=False, is_contiguous=lambda: True)


def test_bf16_is_taken_by_b14_only():
    """B14 takes bfloat16 throughout on the card; every other kernel
    refuses it among its factors with the error it gave before, and the
    bfloat16-data entries (B1, B2, B7, B8, B9) take it in their data group
    alone, beside float32 factors."""
    q = _on_card((1, 2, 8, 16), torch.bfloat16)
    assert _build.cuda_device("attention", q, q, q,
                              dtypes=fa_ops.DTYPES) == q.device
    with pytest.raises(TypeError, match="float32 or float64"):
        _build.cuda_device("build_gram", q)
    f32, f64 = (_on_card((1, 8, 8), dt) for dt in (torch.float32,
                                                   torch.float64))
    assert _build.cuda_device("build_gram", data=(q,)) == q.device
    assert _build.cuda_device("build_cross", f32, data=(q, q)) == q.device
    with pytest.raises(TypeError, match="bfloat16 beside float32"):
        _build.cuda_device("build_cross", f64, data=(q, q))
    with pytest.raises(TypeError, match="float32 of one dtype"):
        ssd_ops.ssd_intra_chunk(*(_on_card(s, torch.bfloat16) for s in (
            (2, 1, 8, 4), (2, 1, 8, 4), (2, 1, 8, 4), (2, 1, 8))))
    assert _build.SUFFIX[torch.bfloat16] == "bf16"
    assert {"flash_attention", "ssd_chunk"} <= set(_build.KERNELS)


def test_window_on_the_card_raises():
    q = _on_card((1, 2, 8, 16), torch.bfloat16)
    with pytest.raises(NotImplementedError, match="sliding windows"):
        fa_ops.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="head dim"):
        big = _on_card((1, 2, 8, 160), torch.float32)
        fa_ops.flash_attention(big, big, big)


# ---------------------------------------------------------------------------
# B15: the SSD intra-chunk stage's plain version
# ---------------------------------------------------------------------------

def _ssd_block(seed, bh=6, nc=2, q=16, n=8, p=8):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((bh, nc, q, n)).astype(F32)
    b = rng.standard_normal((bh, nc, q, n)).astype(F32)
    xdt = rng.standard_normal((bh, nc, q, p)).astype(F32)
    cs = np.cumsum(-rng.uniform(0.05, 1.0, (bh, nc, q)), -1).astype(F32)
    return c, b, xdt, cs


def _state(*arrays):
    """The process state a float32 comparison depends on, for the failure
    message: JAX's x64 flag and default matmul precision, the dtypes the
    JAX side computed in, torch's float32 matmul flags and threads."""
    return (f"jax_enable_x64={jax.config.jax_enable_x64} "
            f"jax_default_matmul_precision="
            f"{jax.config.jax_default_matmul_precision} jax dtypes "
            f"{[str(a.dtype) for a in arrays]} torch allow_tf32 "
            f"{torch.backends.cuda.matmul.allow_tf32} threads "
            f"{torch.get_num_threads()}")


def test_ssd_intra_chunk_matches_reference_and_pallas():
    args = _ssd_block(0)
    got = ssd_intra_chunk_ref(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, args))
    # the JAX side pinned: float32 inputs (above) and full-precision
    # products, whatever another test left in jax.config (ROADMAP C9)
    with jax.default_matmul_precision("highest"):
        want_ref = jssd_ref(*jargs)
        want_pallas = jssd_intra_chunk(*jargs, interpret=True)
    state = _state(*jargs, want_ref, want_pallas)
    for want in (want_ref, want_pallas):
        try:
            _close(got, want, 1e-5)
        except AssertionError as err:
            raise AssertionError(f"{err}; {state}") from None
    launches = ssd_ops.ssd_intra_chunk.launches
    torch.testing.assert_close(
        ssd_ops.ssd_intra_chunk(*map(torch.from_numpy, args)), got, rtol=0,
        atol=0)
    assert ssd_ops.ssd_intra_chunk.launches == launches


def _ssm_inputs(seed, b=2, s=32, h=4, p=8, g=1, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(F32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(F32)
    a = -np.exp(rng.uniform(-1.0, 0.5, h)).astype(F32)
    bm = rng.standard_normal((b, s, g, n)).astype(F32)
    cm = rng.standard_normal((b, s, g, n)).astype(F32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("groups,chunk", [(1, 16), (2, 8), (2, 32)])
def test_ssd_chunked_matches_reference(groups, chunk):
    args = _ssm_inputs(groups + chunk, g=groups)
    got = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    jargs = tuple(map(jnp.asarray, args))
    _close(got, jssm.ssd_chunked(*jargs, chunk=chunk), 1e-5)
    _close(got, jssm.ssd_reference(*jargs), 1e-4)
    _close(ssm.ssd_reference(*map(torch.from_numpy, args)),
           jssm.ssd_reference(*jargs), 1e-5)


def test_ssd_chunked_ragged_raises():
    args = _ssm_inputs(0, s=24)
    with pytest.raises(ValueError, match="S % chunk"):
        ssm.ssd_chunked(*map(torch.from_numpy, args), chunk=16)


def test_ssd_decode_step_and_conv_match_reference():
    rng = np.random.default_rng(5)
    state = rng.standard_normal((2, 4, 8, 8)).astype(F32)
    x, dt = (rng.standard_normal(s).astype(F32) for s in ((2, 4, 8), (2, 4)))
    dt = np.abs(dt)
    a = -np.abs(rng.standard_normal(4)).astype(F32)
    bv, cv = (rng.standard_normal((2, 2, 8)).astype(F32) for _ in range(2))
    got = ssm.ssd_decode_step(*map(torch.from_numpy, (state, x, dt, a, bv, cv)))
    want = jssm.ssd_decode_step(*map(jnp.asarray, (state, x, dt, a, bv, cv)))
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    xs = rng.standard_normal((2, 6, 5)).astype(F32)
    w = rng.standard_normal((4, 5)).astype(F32)
    cache = rng.standard_normal((2, 3, 5)).astype(F32)
    for c in (None, cache):
        got = ssm.causal_conv1d(torch.from_numpy(xs), torch.from_numpy(w),
                                None if c is None else torch.from_numpy(c))
        want = jssm.causal_conv1d(jnp.asarray(xs), jnp.asarray(w),
                                  None if c is None else jnp.asarray(c))
        for g, wnt in zip(got, want):
            _close(g, wnt, 1e-6)


# ---------------------------------------------------------------------------
# HCK decode (Algorithm 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,levels", [(64, 2), (96, 3)])
def test_hck_decode_matches_reference(s, levels):
    rng = np.random.default_rng(s)
    b, h, hkv, d, r = 2, 4, 2, 16, 8
    k = rng.standard_normal((b, hkv, s, d)).astype(F32)
    v = rng.standard_normal((b, hkv, s, d)).astype(F32)
    lm = rng.standard_normal((levels, r, d)).astype(F32)
    q = rng.standard_normal((b, h, 1, d)).astype(F32)
    kn, vn = (rng.standard_normal((b, hkv, 1, d)).astype(F32)
              for _ in range(2))
    cfg = ab.HCKAttnConfig(leaf=16, rank=r, levels=levels)
    jcfg = jab.HCKAttnConfig(leaf=16, rank=r, levels=levels)
    assert cfg.for_seq(s).levels == jcfg.for_seq(s).levels
    st = ab.build_hck_decode_state(torch.from_numpy(k), torch.from_numpy(v),
                                   cfg=cfg, landmarks=torch.from_numpy(lm))
    jst = jab.build_hck_decode_state(jnp.asarray(k), jnp.asarray(v),
                                     cfg=jcfg, landmarks=jnp.asarray(lm))
    for f in ab.HCKDecodeState.FIELDS:
        _close(getattr(st, f), getattr(jst, f), 1e-5)
    _close(ab.hck_decode_attention(torch.from_numpy(q), st),
           jab.hck_decode_attention(jnp.asarray(q), jst), 1e-5)
    st2 = ab.hck_decode_append(st, torch.from_numpy(kn), torch.from_numpy(vn))
    jst2 = jab.hck_decode_append(jst, jnp.asarray(kn), jnp.asarray(vn))
    for f in ("window_k", "window_v", "win_len"):
        _close(getattr(st2, f), getattr(jst2, f), 0)
    _close(ab.hck_decode_attention(torch.from_numpy(q), st2),
           jab.hck_decode_attention(jnp.asarray(q), jst2), 1e-5)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 4, 1, 16)).astype(F32)
    kc, vc = (rng.standard_normal((2, 2, 40, 16)).astype(F32)
              for _ in range(2))
    for length, window in ((25, 0), (40, 8)):
        got = ab.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                                  window=window, length=length)
        want = jab.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                                    window=window,
                                    length=jnp.asarray(length, jnp.int32))
        _close(got, want, 1e-6)
