"""Port parity: the mixed-precision policy (ROADMAP A15a,
``SolveConfig.precision`` "bf16" / "f32" / "f64").

At the reference's scale (tests/test_precision.py: 256 points, d 5, 3
levels, rank 16, gaussian sigma 2, jitter 1e-4), the reference's tree and
landmark indices injected into the port's builds:

  * the policy maps to the reference's (GEMM dtype, factor dtype) pairs,
    an unknown policy is rejected;
  * float64 -> bfloat16 rounds alike in both frameworks, bit for bit;
  * every policy's factors and operators against the f64 oracle, at the
    reference's bounds (Gram-family factors 2e-2 bf16 / 1e-4 f32; matvec
    and predictions 5e-2 / 1e-4), and against the reference's own policy
    builds: f32 against its xla lane to 1e-4 (f32 arithmetic on the same
    inputs, another summation order); bf16 against its Pallas lane to
    1e-4 (both write float32 factors from the same bf16-rounded data) and
    against its xla lane within one bfloat16 rounding (2^-8 relative, that
    lane rounds its bf16 stage outputs to bfloat16) plus 1e-4;
  * the ridge floor (tests/test_precision.py:126-146), the sweep engine
    and streamed ingestion under bf16, and the counterparts of the
    reference's update (test_update_engine.py:339-360), landmark-policy
    (test_landmark_policies.py:130-) and robustness
    (test_robustness.py:191-239) checks of the policy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws

from repro.core import hck as jhck
from repro.core import oos as joos
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro.kernels.registry import precision_policy as jprecision_policy
from repro.runtime import recover as jrecover
from repro.testing import faultinject as jfi
from repro_torch.core import hck, hmatrix, krr, oos
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.data import pipeline
from repro_torch.kernels import registry
from repro_torch.kernels.registry import SolveConfig, precision_policy
from repro_torch.runtime import health, recover
from repro_torch.testing import faultinject as fi

N, D, LEVELS, RANK, SIGMA, JITTER = 256, 5, 3, 16, 2.0, 1e-4
#: (factor gate, operator gate) against the f64 oracle
#: (tests/test_precision.py:20)
TOLS = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 5e-2)}
#: the port's factors against the reference's policy builds, relative to
#: each factor's largest entry: f32 against the xla lane (f32 arithmetic
#: in another summation order; U and W carry kappa(Sigma) ~ 1e2 of it:
#: 1.1e-5 read); bf16 against the Pallas lane (both float32 outputs of the
#: same bf16 data); bf16 against the xla lane, which rounds each stage
#: output to bf16 once: 2^-8 of each entry plus this floor
PARITY_F32, PARITY_BF16, XLA_BF16_FLOOR = 1e-4, 1e-4, 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= rtol, err


def _gram_family(f):
    return [f.adiag, *f.sigma, *f.sigma_cho]


def _factor_err(f, ref) -> float:
    return max(_rel(a, b) for a, b in zip(_gram_family(f),
                                          _gram_family(ref)))


@pytest.fixture(scope="module")
def mp(f64):
    """The reference's problem: x, b, its f64 build (key 1), the port's
    builds per policy on that tree and those landmarks (None = the f64
    oracle), and the queries and weights of the prediction gates."""
    x = jax.random.normal(jax.random.PRNGKey(0), (N, D), jnp.float64)
    jker = JKernel("gaussian", sigma=SIGMA, jitter=JITTER)
    key = jax.random.PRNGKey(1)
    jf = jhck.build_hck(x, levels=LEVELS, rank=RANK, key=key, kernel=jker)
    draws = dict(directions=[_t(v) for v in jf.tree.directions],
                 landmark_index=landmark_draws(key, N, LEVELS, RANK))
    ker = BaseKernel("gaussian", SIGMA, JITTER)

    def build(prec, kernel=ker, xx=None):
        cfg = SolveConfig(precision=prec)
        return hck.build_hck(_t(x) if xx is None else xx, levels=LEVELS,
                             rank=RANK, kernel=kernel, config=cfg, **draws)

    builds = {p: build(p) for p in (None, "f64", "f32", "bf16")}
    b = jax.random.normal(jax.random.PRNGKey(2), (N, 2), jnp.float64)
    w = jax.random.normal(jax.random.PRNGKey(3), (N, 2), jnp.float64)
    q = jax.random.normal(jax.random.PRNGKey(4), (64, D), jnp.float64)
    return dict(x=x, jf=jf, jker=jker, key=key, ker=ker, draws=draws,
                build=build, f=builds, b=np.asarray(b), w=w, q=q)


# ---------------------------------------------------------------------------
# policy plumbing
# ---------------------------------------------------------------------------

def test_policy_mapping_and_rejection():
    assert registry.PRECISIONS == ("bf16", "f32", "f64")
    assert precision_policy(None) is None
    assert precision_policy(SolveConfig()) is None
    for prec, want in (("bf16", (torch.bfloat16, torch.float32)),
                       ("f32", (torch.float32, torch.float32)),
                       ("f64", (torch.float64, torch.float64))):
        assert precision_policy(SolveConfig(precision=prec)) == want
        jgemm, jfac = jprecision_policy(JSolveConfig(precision=prec))
        assert (str(want[0]).removeprefix("torch."),
                str(want[1]).removeprefix("torch.")) == (jgemm.name,
                                                         jfac.name)
    for bad in ("fp16", "bfloat16", "f16"):
        with pytest.raises(ValueError, match="precision"):
            SolveConfig(precision=bad)
        with pytest.raises(ValueError, match="precision"):
            JSolveConfig(precision=bad)


def test_bf16_casts_equal_bit_for_bit(f64):
    """float64 -> bfloat16 in torch and in JAX, as bit patterns: 2,000,000
    standard normal values, powers of two and their neighbours, and a
    double-rounding case (1 + 2^-8 + 2^-30, just above a bfloat16
    midpoint, whose float32 image is the midpoint itself).  Subnormal
    bfloat16 results are left out: JAX flushes them to zero, torch keeps
    them, and no datum of a policy comes near 1e-38."""
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.standard_normal(2_000_000),
        np.ldexp(1.0, np.arange(-126, 127)),
        np.nextafter(np.ldexp(1.0, np.arange(-126, 127)), np.inf),
        [1 + 2.0 ** -8 + 2.0 ** -30, 1 + 2.0 ** -8, -(1 + 2.0 ** -8),
         0.0, -0.0, 3.0e38, 1e-30]])
    ours = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy()
    theirs = np.asarray(jnp.asarray(v, jnp.float64).astype(
        jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(ours, theirs)
    # through the port's policy: the stage's data cast, a float32 input
    x32 = torch.from_numpy(v[:4096].astype(np.float32))
    np.testing.assert_array_equal(
        x32.to(torch.bfloat16).view(torch.int16).numpy(),
        np.asarray(jnp.asarray(v[:4096], jnp.float32).astype(
            jnp.bfloat16)).view(np.int16))


# ---------------------------------------------------------------------------
# build and predict bounds against the f64 oracle
# ---------------------------------------------------------------------------

def test_f64_policy_is_the_f64_build(mp):
    """The "f64" policy on float64 data is the dtype-preserving build bit
    for bit, and both are the reference's f64 build to round-off."""
    f, f64 = mp["f"]["f64"], mp["f"][None]
    for a, b in zip(_gram_family(f) + [f.u, *f.w],
                    _gram_family(f64) + [f64.u, *f64.w]):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    jf = mp["jf"]
    for a, b in zip(_gram_family(f64) + [f64.u],
                    _gram_family(jf) + [jf.u]):
        _close(a, b, 1e-10)


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_build_precision_bounds(mp, prec):
    ftol, otol = TOLS[prec]
    f, ref = mp["f"][prec], mp["f"][None]
    # the tree and the landmarks precede the cast
    assert torch.equal(f.tree.perm, ref.tree.perm)
    assert all(torch.equal(a, b) for a, b in zip(f.landmarks, ref.landmarks))
    assert f.x_sorted.dtype == torch.float64
    assert f.u.dtype == f.adiag.dtype == torch.float32
    err = _factor_err(f, ref)
    assert err <= ftol, f"{prec} factors: {err:.2e} > {ftol}"
    b = torch.from_numpy(mp["b"])
    mv = _rel(hmatrix.matvec(f, b.float()), hmatrix.matvec(ref, b))
    assert mv <= otol, f"{prec} matvec: {mv:.2e} > {otol}"


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_predict_precision_bounds(mp, prec):
    """f64 factors, a mixed-precision apply: the serving side's policy
    (data cast to the GEMM dtype, weights to the factor dtype), through
    the prediction engine as well, which casts the stacks once."""
    _, otol = TOLS[prec]
    f, ker = mp["f"][None], mp["ker"]
    w, q = _t(mp["w"]), _t(mp["q"])
    plan = oos.prepare(f, w)
    want = oos.apply_plan(f, plan, q, ker)
    cfg = SolveConfig(precision=prec)
    got = oos.apply_plan(f, plan, q, ker, cfg)
    assert got.dtype == torch.float32
    err = _rel(got, want)
    assert err <= otol, f"{prec} predict: {err:.2e} > {otol}"
    from repro_torch.serving.predict_service import PredictEngine

    eng = PredictEngine(f, plan, ker, config=cfg, min_bucket=8)
    xl, wl, lm, ct = eng._stacks
    assert xl.dtype == lm.dtype == precision_policy(cfg)[0]
    assert wl.dtype == ct.dtype == torch.float32
    assert torch.equal(eng(q), got)
    # the reference's policy apply, the same gate
    jwant = joos.predict(mp["jf"], mp["w"], mp["q"], mp["jker"])
    jgot = joos.predict(mp["jf"], mp["w"], mp["q"], mp["jker"],
                        JSolveConfig(precision=prec))
    assert _rel(jgot, jwant) <= otol
    _close(want, jwant, 1e-10)


# ---------------------------------------------------------------------------
# the port's policy builds against the reference's
# ---------------------------------------------------------------------------

def _jbuild(mp, prec, backend):
    return jhck.build_hck(
        jnp.asarray(mp["x"]), levels=LEVELS, rank=RANK, key=mp["key"],
        kernel=mp["jker"],
        config=JSolveConfig(backend=backend, interpret=True,
                            precision=prec))


def test_f32_factors_match_the_reference(mp):
    f, jf = mp["f"]["f32"], _jbuild(mp, "f32", "xla")
    for a, b in zip(_gram_family(f) + [f.u, *f.w],
                    _gram_family(jf) + [jf.u, *jf.w]):
        _close(a, b, PARITY_F32)


def test_bf16_factors_match_the_reference(mp):
    """Against the reference's Pallas lane (float32 outputs, as the port's
    kernels and plain versions write them) to PARITY_BF16; against its
    xla lane, which rounds each stage output to bfloat16, within one
    bf16 rounding of each Gram-family entry."""
    f = mp["f"]["bf16"]
    jp = _jbuild(mp, "bf16", "pallas")
    for a, b in zip(_gram_family(f) + [f.u],
                    _gram_family(jp) + [jp.u]):
        _close(a, b, PARITY_BF16)
    jx = _jbuild(mp, "bf16", "xla")
    for a, b in zip(_gram_family(f), _gram_family(jx)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert (np.abs(a - b) <= 2.0 ** -8 * np.abs(b)
                + XLA_BF16_FLOOR * np.abs(b).max()).all()


# ---------------------------------------------------------------------------
# inversion: the bf16 ridge floor (tests/test_precision.py:126-146)
# ---------------------------------------------------------------------------

def test_inversion_ridge_floor(mp):
    b = torch.from_numpy(mp["b"])
    ref = mp["f"][None]
    # f32 builds invert at any ridge the f64 oracle takes
    z32 = hmatrix.solve(mp["f"]["f32"], b.float(), ridge=1e-2)
    assert torch.isfinite(z32).all()
    assert _rel(z32, hmatrix.solve(ref, b, ridge=1e-2)) <= 5e-3
    # bf16-built factors at the documented floor (~1e-1 at n0 = 32): finite
    # and within an octave of the forward bound
    zbf = hmatrix.solve(mp["f"]["bf16"], b.float(), ridge=1e-1)
    assert torch.isfinite(zbf).all()
    assert _rel(zbf, hmatrix.solve(ref, b, ridge=1e-1)) <= 1e-1


# ---------------------------------------------------------------------------
# the sweep engine and streamed ingestion under bf16
# ---------------------------------------------------------------------------

def test_sweep_factors_bf16(mp):
    """One plan (float64 distance tiles), the factors at sigma 2 under the
    bf16 policy: the tiles themselves are cast (the reference's
    semantics), within the build bounds of the f64 oracle; the plan stays
    float64 and the f32 policy sweep equals the f32 policy build to f32
    round-off."""
    plan = hck.build_sweep_plan(_t(mp["x"]), levels=LEVELS, rank=RANK,
                                device="cpu", **mp["draws"])
    assert plan.leaf_self.dtype == torch.float64
    ker, ref = mp["ker"], mp["f"][None]
    fb = hck.sweep_factors(plan, ker, SolveConfig(precision="bf16"))
    assert fb.u.dtype == fb.adiag.dtype == torch.float32
    ftol, otol = TOLS["bf16"]
    assert _factor_err(fb, ref) <= ftol
    b = torch.from_numpy(mp["b"])
    assert _rel(hmatrix.matvec(fb, b.float()), hmatrix.matvec(ref, b)) <= otol
    f32 = hck.sweep_factors(plan, ker, SolveConfig(precision="f32"))
    for a, c in zip(_gram_family(f32), _gram_family(mp["f"]["f32"])):
        _close(a, c, 1e-5)


def test_fit_streaming_bf16_equals_fit():
    """The streamed bf16 model is the in-memory bf16 one on one generator:
    the tree, pad rows and landmarks bit for bit, factors, alpha and
    predictions to f32 round-off (the leaf stages run in groups of
    leaves); both keep the policy and take an online update alike."""
    gen = torch.Generator().manual_seed(21)
    x = torch.randn((147, 3), generator=gen, dtype=torch.float64)
    y = torch.sin(x[:, 0]) + 0.1 * x[:, 1]
    cfg = SolveConfig(precision="bf16")
    opts = dict(kernel=BaseKernel("gaussian", 1.5, 1e-4), lam=1e-1, rank=8,
                leaf_size=10, device="cpu", solve_config=cfg)
    m = krr.fit(x, y, generator=torch.Generator().manual_seed(5), **opts)
    ms = krr.fit_streaming(pipeline.ArraySource(x), y, leaf_batch=3,
                           chunk_rows=19,
                           generator=torch.Generator().manual_seed(5),
                           **opts)
    fa, fb = m.factors, ms.factors
    assert torch.equal(fa.tree.perm, fb.tree.perm)
    assert torch.equal(fa.x_sorted, fb.x_sorted)
    assert all(torch.equal(a, b) for a, b in zip(fa.landmarks, fb.landmarks))
    assert fb.u.dtype == ms.alpha.dtype == torch.float32
    for a, b in zip(_gram_family(fa) + [fa.u, *fa.w],
                    _gram_family(fb) + [fb.u, *fb.w]):
        _close(a, b, 1e-5)
    _close(ms.alpha, m.alpha, 1e-4)
    _close(ms.predict(x[:9]), m.predict(x[:9]), 1e-4)
    assert ms.solve_config is cfg
    xn = torch.randn((11, 3), generator=gen, dtype=torch.float64)
    ua, _ = m.update(xn, torch.sin(xn[:, 0]))
    ub, _ = ms.update(xn, torch.sin(xn[:, 0]))
    _close(ub.alpha, ua.alpha, 1e-4)


# ---------------------------------------------------------------------------
# counterparts of the reference's policy checks
# ---------------------------------------------------------------------------

def _target(x):
    return torch.sin(x[:, 0]) + 0.25 * torch.cos(2.0 * x[:, 1])


@pytest.mark.parametrize("precision,lam,jitter,max_resid", [
    ("f32", 1e-2, 1e-5, 1e-4),
    ("bf16", 1e-1, 1e-4, 1e-2),
])
def test_update_definite_at_documented_jitter_floor(precision, lam, jitter,
                                                    max_resid):
    """tests/test_update_engine.py:339-360: at the launcher's convention
    (bf16 lambda 1e-1 / jitter 1e-4, f32 1e-2 / 1e-5) the bordered
    extension of an online update stays positive definite: finite
    factors, alpha and predictions, a small residual."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((256, 5), generator=gen)
    cfg = SolveConfig(precision=precision)
    model = krr.fit(x, _target(x), kernel=BaseKernel("gaussian", 2.0,
                                                     jitter),
                    lam=lam, rank=16, leaf_size=32, levels=3, device="cpu",
                    solve_config=cfg,
                    generator=torch.Generator().manual_seed(1))
    x_new = torch.randn((12, 5), generator=gen)
    m2, info = model.update(x_new, _target(x_new),
                            generator=torch.Generator().manual_seed(6))
    for t in (m2.factors.adiag, m2.factors.u, m2.alpha):
        assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert info.residual < max_resid
    z = m2.predict(torch.randn((32, 5), generator=gen))
    assert torch.isfinite(z).all()


@pytest.mark.parametrize("precision,jitter", [("bf16", 1e-4),
                                              ("f32", 1e-6),
                                              ("f64", 1e-8)])
@pytest.mark.parametrize("policy", ["uniform", "kmeans", "leverage"])
def test_policy_pd_across_precisions(f64, policy, precision, jitter):
    """tests/test_landmark_policies.py:130-: every landmark policy gives a
    strictly positive definite Sigma under every precision policy (the
    selection runs in the input dtype, before the cast)."""
    x = torch.randn((256, 4), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    f = hck.build_hck(x, levels=3, rank=16,
                      kernel=BaseKernel("gaussian", 2.0, jitter),
                      policy=policy, config=SolveConfig(precision=precision),
                      generator=torch.Generator().manual_seed(1))
    plain = hck.build_hck(x, levels=3, rank=16,
                          kernel=BaseKernel("gaussian", 2.0, jitter),
                          policy=policy,
                          generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(f.landmarks,
                                                 plain.landmarks))
    for cho in f.sigma_cho:
        assert torch.isfinite(cho).all()
        assert (torch.diagonal(cho, dim1=-2, dim2=-1) > 0).all()


def test_bf16_ridge_floor_detect_recover(mp):
    """tests/test_robustness.py:191-239: bf16-built factors (jitter 1e-6,
    the factors rounded as the reference's xla lane stores them) inverted
    at a ridge far below n0 * eps_bf16: the leaf Schur Cholesky fails and
    the probe names it; the ladder's promotion rung (every factor rebuilt
    in f32 on the frozen hierarchy, the ORIGINAL ridge) repairs it, as the
    reference's ladder does on its own bf16 build."""
    x32 = _t(np.asarray(mp["x"], np.float32))
    draws = dict(mp["draws"], directions=[d.float()
                                          for d in mp["draws"]["directions"]])
    cfg = SolveConfig(checks=True)
    f, ker, cfg16 = fi.bf16_ridge_floor_factors(
        x32, levels=LEVELS, rank=RANK, kernel=mp["ker"], config=cfg, **draws)
    assert cfg16.precision == "bf16" and cfg16.checks and ker.jitter == 1e-6
    assert health.probe_factors(f, cfg16)     # the build itself is finite
    ridge = 1e-3
    _, lo = hmatrix.invert_with_leaf(f, ridge, cfg16)
    with pytest.raises(health.NumericalFailure) as ei:
        health.probe_leaf_factor(lo, cfg16)
    assert ei.value.stage == "leaf_factor"
    # the same bf16 build unrounded (float32 factors, as the port's stages
    # and the reference's Pallas lane write them) inverts at this ridge
    # (ROADMAP C17)
    f32out = hck.build_hck(x32, levels=LEVELS, rank=RANK, kernel=ker,
                           config=cfg16, **draws)
    _, lo32 = hmatrix.invert_with_leaf(f32out, ridge, cfg16)
    assert health.probe_leaf_factor(lo32, cfg16)
    g = recover.invert_guarded(f, ridge, cfg16, kernel=ker, jitter_rungs=0)
    assert not g.audit.attempts[0].ok
    assert g.audit.rungs == ["initial", "promote:f32"] and g.ridge == ridge
    assert g.config.precision == "f32"
    b = torch.randn((N, 1), generator=torch.Generator().manual_seed(8))
    alpha = hmatrix.solve_with_inverse(g.factors, g.inverse, b,
                                       ridge=g.ridge, config=g.config)
    assert torch.isfinite(alpha).all()
    f64f = recover._cast_float(g.factors, torch.float64)
    kd = hmatrix.matvec_dense_reference(f64f, torch.eye(N,
                                                        dtype=torch.float64))
    a64 = alpha.double()
    resid = kd @ a64 + ridge * a64 - b.double()
    assert float(resid.norm() / b.norm()) < 1e-2
    # the reference's ladder on its own bf16 build climbs the same rungs
    jcfg = JSolveConfig(backend="xla", checks=True, precision="bf16")
    jker = JKernel("gaussian", sigma=SIGMA, jitter=1e-6)
    jf = jhck.build_hck(jnp.asarray(mp["x"], jnp.float32), levels=LEVELS,
                        rank=RANK, key=mp["key"], kernel=jker, config=jcfg)
    jg = jrecover.invert_guarded(jf, ridge, jcfg, kernel=jker,
                                 jitter_rungs=0)
    assert jg.audit.rungs == g.audit.rungs
    assert jfi.FAULT_CLASSES["bf16_ridge_floor"] == fi.FAULT_CLASSES[
        "bf16_ridge_floor"]
    assert "bf16_ridge_floor" not in fi.A15_FAULTS


# ---------------------------------------------------------------------------
# the wrappers' card path under bf16 data, the launch recorded
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrappers' card path: the device check
    passes them and the launch records (library, symbol, args)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.oos_stage import ops as oops

    calls = []
    monkeypatch.setattr(_build, "cuda_device",
                        lambda stage, *ts, **kw: torch.device("cpu"))
    monkeypatch.setattr(_build, "launch",
                        lambda name, symbol, dev, *args:
                        calls.append((name, symbol, args)))
    for fn in (bops.build_gram_levels, bops.build_cross_levels,
               bops.build_gram_dist, bops.build_gram_dist_levels,
               bops.build_cross_dist_levels, oops.oos_contract):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "bf16_launches", 0)
    monkeypatch.setattr(oops.oos_contract, "pair_launches", 0)
    return calls


@pytest.mark.parametrize("d", [3, 7, 18, 54])
def test_bf16_wrappers_launch_their_entries(fake_card, d):
    """Each wrapper given bfloat16 data and float32 factors launches its
    ``_bf16`` entry from its library's ``_bf16`` library, writes float32
    and counts the launch as bf16; B7's
    plan holds the data slots in bfloat16 (2-byte elements, 16-byte
    slots) and copies a block of 2-byte-aligned base or size 2 bytes a
    piece (rows of 2d bytes: 6, 14, 36, 108)."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.oos_stage import ops as oops

    bf, f32 = torch.bfloat16, torch.float32
    pts = [torch.zeros((2, 37, d), dtype=bf), torch.zeros((4, 16, d),
                                                           dtype=bf)]
    out = bops.build_gram_levels(pts)
    assert all(g.dtype == c.dtype == f32 for g, c in out)
    lm, li = torch.zeros((3, 24, d), dtype=bf), torch.zeros((3, 24, 24))
    (u,) = bops.build_cross_levels([torch.zeros((3, 50, d), dtype=bf)],
                                   [lm], [li])
    assert u.dtype == f32 and u.shape == (3, 50, 24)
    dist = torch.zeros((3, 37, 37), dtype=bf)
    assert all(t.dtype == f32 for t in bops.build_gram_dist_levels([dist])[0])
    assert bops.build_gram_dist(dist, want_chol=False)[0].dtype == f32
    (u9,) = bops.build_cross_dist_levels([torch.zeros((3, 50, 24),
                                                      dtype=bf)], [li])
    assert u9.dtype == f32
    buf = torch.zeros(8 * 40 * d + 1, dtype=bf)
    xl = buf[1:].view(8, 40, d)                      # base 2 bytes off
    wl, ct = torch.zeros((8, 40, 3)), torch.zeros((8, 24, 3))
    qs = torch.zeros((5, d), dtype=bf)
    idx = torch.tensor([0, 0, 1, 3, 7])
    z = oops.oos_local_walk(xl, wl, torch.zeros((4, 24, d), dtype=bf), ct,
                            qs, idx, idx >> 1)
    assert z.dtype == f32 and z.shape == (5, 3)
    assert [c[:2] for c in fake_card] == [
        ("build_stage_bf16", "gram_chol_levels_bf16"),
        ("build_stage_bf16", "cross_solve_levels_bf16"),
        ("build_dist_bf16", "gram_chol_dist_levels_bf16"),
        ("build_dist_bf16", "gram_dist_bf16"),
        ("build_dist_bf16", "cross_solve_dist_levels_bf16"),
        ("oos_contract_bf16", "oos_contract_bf16")]
    for fn in (bops.build_gram_levels, bops.build_cross_levels,
               bops.build_gram_dist_levels, bops.build_cross_dist_levels,
               oops.oos_contract):
        assert fn.launches == fn.bf16_launches == 1
    assert bops.build_gram_dist.bf16_launches == 1
    args = fake_card[-1][2]
    plan = oops.plan((40, 24), d, 3, 4, None, 2)
    tail = args[18:]
    assert tail[3:9] == (5, d, 3, plan["rows"], plan["warps"], tail[8])
    assert tail[10:13] == (plan["pslot"], plan["wslot"], plan["xslot"])
    assert plan["pslot"] * 2 % 16 == plan["xslot"] * 2 % 16 == 0
    assert plan["smem"] <= oops.SMEM_BUDGET
    assert (args[7], tail[8]) == (2, oops.copy_width(qs.data_ptr(), 2 * d))
    assert d % tail[9] == 0 and tail[9] * 2 <= 16
    assert oops.warp_smem(40, d, 3, 4, 2) < oops.warp_smem(40, d, 3, 4)
