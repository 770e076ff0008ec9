"""Port parity: Algorithm-3 prediction (repro_torch.core.oos) and its stages.

The same numpy inputs go through the JAX reference (float64, Pallas in
interpret mode where it has a kernel) and the port's plain PyTorch path on
the CPU.  Tolerances: 1e-12 relative for single stages, 1e-10 for the
multi-level plan (its pushdown chains L products and a Cholesky solve).
The CUDA kernels themselves run only on the card (chip_smoke.py holds
them against these plain versions there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import oos as joos
from repro.core.hck import build_hck
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.core.kernels_fn import get_kernel as jget_kernel
from repro.kernels.hck_leaf.ops import leaf_project as jleaf_project
from repro.kernels.oos_stage.ops import oos_contract as joos_contract
from repro.kernels.registry import STAGES as JSTAGES
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch import convert, device
from repro_torch.core import oos
from repro_torch.core.kernels_fn import BaseKernel, get_kernel
from repro_torch.kernels import registry
from repro_torch.kernels.hck_leaf import ops as leaf_ops
from repro_torch.kernels.hck_leaf.ref import hck_leaf_project_ref
from repro_torch.kernels.oos_stage import ops as oos_ops
from repro_torch.kernels.oos_stage.ref import oos_contract_ref

KERNELS = ["gaussian", "imq", "laplace"]
N, D, RANK, LEAF = 512, 3, 8, 16        # 5 levels, 32 leaves
SIGMA, JITTER = 1.5, 1e-8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max()


def flatten_model(factors, plan, alpha=None, classes=None, inverse=None,
                  leaf_lo=None):
    """The reference's model arrays as the flat dict repro_torch.convert reads."""
    arrays = {"x_sorted": factors.x_sorted, "perm": factors.tree.perm,
              "u": factors.u, "adiag": factors.adiag,
              "plan.w_leaf": plan.w_leaf, "plan.c_tilde": plan.c_tilde,
              "leaf_lo": leaf_lo}
    for field in ("directions", "thresholds"):
        for i, v in enumerate(getattr(factors.tree, field)):
            arrays[f"{field}/{i}"] = v
    for field in ("landmarks", "sigma", "sigma_cho", "w"):
        for i, v in enumerate(getattr(factors, field)):
            arrays[f"{field}/{i}"] = v
    for i, v in enumerate(plan.c):
        arrays[f"plan.c/{i}"] = v
    if alpha is not None:
        arrays["alpha"] = alpha
    if classes is not None:
        arrays["classes"] = classes
    if inverse is not None:
        for field in ("adiag", "u", "logabsdet", "linv"):
            arrays[f"inverse.{field}"] = getattr(inverse, field)
        for field in ("sigma", "w"):
            for i, v in enumerate(getattr(inverse, field)):
                arrays[f"inverse.{field}/{i}"] = v
    return {k: np.asarray(v) for k, v in arrays.items() if v is not None}


@pytest.fixture(scope="module")
def model(f64):
    """A reference build (n=512, d=3, rank 8, leaf 16) with a 2-column w."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D))
    w = rng.standard_normal((N, 2))
    ker = JKernel("gaussian", sigma=SIGMA, jitter=JITTER)
    f = build_hck(jnp.asarray(x), levels=5, rank=RANK,
                  key=jax.random.PRNGKey(1), kernel=ker)
    return f, ker, jnp.asarray(w)


# ---------------------------------------------------------------------------
# kernels_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", KERNELS)
def test_base_kernels_match_reference(f64, name):
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((17, 4)) * 2, rng.standard_normal((9, 4))
    want = jget_kernel(name)(jnp.asarray(x), jnp.asarray(y), sigma=0.7)
    _close(get_kernel(name)(_t(x), _t(y), sigma=0.7), want, 1e-13)
    jk, k = JKernel(name, 0.7, 1e-3), BaseKernel(name, 0.7, 1e-3)
    _close(k.gram(_t(x)), jk.gram(jnp.asarray(x)), 1e-13)


# ---------------------------------------------------------------------------
# B6 leaf_project and B7 oos_contract: plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

def test_leaf_project_ref_matches_pallas(f64):
    rng = np.random.default_rng(2)
    u, b = rng.standard_normal((32, LEAF, RANK)), rng.standard_normal((32, LEAF, 3))
    want = jleaf_project(jnp.asarray(u), jnp.asarray(b), interpret=True)
    _close(hck_leaf_project_ref(_t(u), _t(b)), want, 1e-13)
    # the wrapper takes the plain version on CPU tensors and launches nothing
    before = leaf_ops.leaf_project.launches
    _close(leaf_ops.leaf_project(_t(u), _t(b)), want, 1e-13)
    assert leaf_ops.leaf_project.launches == before


@pytest.mark.parametrize("m", [LEAF, RANK], ids=["oos_local", "oos_walk"])
@pytest.mark.parametrize("name", KERNELS)
def test_oos_contract_ref_matches_pallas(f64, name, m):
    rng = np.random.default_rng(3)
    q = 40
    pts = rng.standard_normal((q, m, D))
    w = rng.standard_normal((q, m, 3))
    xs = rng.standard_normal((q, D))
    want = joos_contract(jnp.asarray(pts), jnp.asarray(w), jnp.asarray(xs),
                         name=name, sigma=SIGMA, interpret=True)
    idx = torch.arange(q)
    got = oos_contract_ref(_t(pts), _t(w), _t(xs), idx, idx, name=name,
                           sigma=SIGMA)
    _close(got, want, 1e-12)
    before = oos_ops.oos_contract.launches
    got = oos_ops.oos_contract(_t(pts), _t(w), _t(xs), idx, idx, name=name,
                               sigma=SIGMA)
    _close(got, want, 1e-12)
    assert oos_ops.oos_contract.launches == before


@pytest.mark.parametrize("name", KERNELS)
def test_oos_contract_indexed_equals_gathered(f64, name):
    """Reading blocks in place through indices is the gathered contraction."""
    rng = np.random.default_rng(4)
    pts, w = _t(rng.standard_normal((6, LEAF, D))), _t(rng.standard_normal((12, LEAF, 2)))
    xs = _t(rng.standard_normal((25, D)))
    widx = torch.from_numpy(np.sort(rng.integers(0, 12, 25)))
    pidx = widx >> 1
    ar = torch.arange(25)
    got = oos_contract_ref(pts, w, xs, pidx, widx, name=name, sigma=SIGMA)
    want = oos_contract_ref(pts[pidx], w[widx], xs, ar, ar, name=name,
                            sigma=SIGMA)
    _close(got, want, 1e-15)


def test_wrappers_reject_bad_shapes():
    u, b = torch.zeros(4, 16, 8), torch.zeros(4, 15, 2)
    with pytest.raises(ValueError, match="leaf_project"):
        leaf_ops.leaf_project(u, b)
    pts, w, xs = torch.zeros(4, 16, 3), torch.zeros(4, 16, 2), torch.zeros(5, 3)
    idx = torch.zeros(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="oos_contract"):
        oos_ops.oos_contract(pts, w, xs[:, :2], idx, idx)
    with pytest.raises(ValueError, match="oos_contract"):
        oos_ops.oos_contract(pts, w, xs, idx[:4], idx)
    with pytest.raises(ValueError, match="unknown base kernel"):
        oos_ops.oos_contract(pts, w, xs, idx, idx, name="cauchy")


def test_stage_rows_fit_shared_memory():
    # covtype width: the whole 128-row block fits at once
    assert oos_ops.stage_rows(128, 54, 4) == 128
    # mnist width (d = 780): as many rows as one warp's two slots of
    # points, weights and query rows hold within a block's shared memory
    rows = oos_ops.stage_rows(128, 780, 4)
    assert rows == 36
    assert (oos_ops.warp_smem(rows, 780, 1, 4) <= oos_ops.SMEM_BUDGET
            < oos_ops.warp_smem(rows + 1, 780, 1, 4))
    assert oos_ops.stage_rows(128, 54, 4, leaf_block=32) == 32
    with pytest.raises(ValueError, match="no room"):
        oos_ops.stage_rows(128, 20000, 4)


# ---------------------------------------------------------------------------
# Algorithm 3: prepare, apply_segments, apply_plan and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prepare_matches_reference(model, backend):
    f, ker, w = model
    jplan = joos.prepare(f, w, JSolveConfig(backend=backend, interpret=True))
    pf = convert.factors_from_arrays(flatten_model(f, jplan), device="cpu")
    plan = oos.prepare(pf, _t(w))
    for got, want in zip(plan.c, jplan.c):
        _close(got, want, 1e-10)
    _close(plan.w_leaf, jplan.w_leaf, 0)
    _close(plan.c_tilde, jplan.c_tilde, 1e-10)


@pytest.mark.parametrize("name", KERNELS)
def test_apply_segments_gathered_matches_reference(f64, name):
    rng = np.random.default_rng(5)
    q = 21
    arrs = [rng.standard_normal(s) for s in
            ((q, LEAF, D), (q, LEAF, 2), (q, RANK, D), (q, RANK, 2), (q, D))]
    want = joos.apply_segments(*map(jnp.asarray, arrs), JKernel(name, SIGMA),
                               JSolveConfig(backend="pallas", interpret=True))
    got = oos.apply_segments(*map(_t, arrs), BaseKernel(name, SIGMA))
    _close(got, want, 1e-12)


def test_apply_plan_and_oracle_match_reference(model):
    f, ker, w = model
    jplan = joos.prepare(f, w)
    pf = convert.factors_from_arrays(flatten_model(f, jplan), device="cpu")
    pker = BaseKernel("gaussian", SIGMA, JITTER)
    plan = convert.plan_from_arrays(flatten_model(f, jplan), device="cpu")
    q = np.random.default_rng(6).standard_normal((45, D))
    want = joos.apply_plan(f, jplan, jnp.asarray(q), ker)
    _close(oos.apply_plan(pf, plan, _t(q), pker), want, 1e-10)
    _close(oos.apply_plan(pf, oos.prepare(pf, _t(w)), _t(q), pker), want,
           1e-10)
    ref = joos.oos_reference_batch(f, jnp.asarray(q[:5]), ker)
    got = oos.oos_reference_batch(pf, _t(q[:5]), pker)
    _close(got, ref, 1e-10)
    # the engine path agrees with the port's own oracle
    _close(oos.apply_plan(pf, plan, _t(q[:5]), pker), got @ _t(w), 1e-9)


def test_flat_model_levels0_matches_reference(f64):
    rng = np.random.default_rng(8)
    x, w, q = (rng.standard_normal(s) for s in ((32, D), (32, 2), (9, D)))
    ker = JKernel("imq", SIGMA, JITTER)
    f = build_hck(jnp.asarray(x), levels=0, rank=4,
                  key=jax.random.PRNGKey(1), kernel=ker)
    jplan = joos.prepare(f, jnp.asarray(w))
    arrays = flatten_model(f, jplan)
    pf = convert.factors_from_arrays(arrays, device="cpu")
    assert pf.levels == 0 and pf.rank == 0
    plan = oos.prepare(pf, _t(w))
    assert plan.c_tilde is None
    pker = BaseKernel("imq", SIGMA, JITTER)
    want = joos.apply_plan(f, jplan, jnp.asarray(q), ker)
    _close(oos.apply_plan(pf, plan, _t(q), pker), want, 1e-12)
    _close(oos.oos_reference_batch(pf, _t(q), pker) @ _t(w), want, 1e-12)


def test_precision_policy_f32_within_documented_bound(model):
    f, ker, w = model
    jplan = joos.prepare(f, w)
    arrays = flatten_model(f, jplan)
    pf = convert.factors_from_arrays(arrays, device="cpu")
    plan = convert.plan_from_arrays(arrays, device="cpu")
    q = _t(np.random.default_rng(7).standard_normal((30, D)))
    pker = BaseKernel("gaussian", SIGMA, JITTER)
    z64 = oos.apply_plan(pf, plan, q, pker)
    z32 = oos.apply_plan(pf, plan, q, pker, registry.SolveConfig(precision="f32"))
    assert z32.dtype == torch.float32
    _close(z32.double(), z64, 1e-4)


# ---------------------------------------------------------------------------
# Registry and device rules
# ---------------------------------------------------------------------------

def test_registry_stages_and_backends():
    assert registry.STAGES == JSTAGES
    assert registry.BACKENDS == ("torch", "cuda")
    cpu = torch.zeros(2)
    assert registry.resolve_backend(None, "oos_local", cpu) == "torch"
    assert registry.resolve_backend(registry.SolveConfig(backend="torch"),
                                    "leaf_project", cpu) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors only"):
        registry.resolve_backend(registry.SolveConfig(backend="cuda"),
                                 "oos_walk", cpu)
    with pytest.raises(ValueError, match="backend"):
        registry.SolveConfig(backend="xla")
    with pytest.raises(ValueError, match="precision"):
        registry.SolveConfig(precision="fp16")
    assert registry.PRECISIONS == ("bf16", "f32", "f64")
    for stage in registry.STAGES:                  # every stage is ported
        for backend in registry.BACKENDS:
            assert callable(registry.get_impl(stage, backend))
    with pytest.raises(KeyError, match="no implementation"):
        registry.get_impl("attention", "xla")      # not a backend of the port
    assert registry.get_impl("oos_walk", "torch") is registry.get_impl(
        "oos_local", "torch")


def test_forced_cuda_on_cpu_tensors_raises(model):
    f, ker, w = model
    jplan = joos.prepare(f, w)
    arrays = flatten_model(f, jplan)
    pf = convert.factors_from_arrays(arrays, device="cpu")
    cfg = registry.SolveConfig(backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        oos.prepare(pf, _t(w), cfg)
    plan = convert.plan_from_arrays(arrays, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        oos.apply_plan(pf, plan, torch.zeros(3, D, dtype=torch.float64),
                       BaseKernel(), cfg)


def test_cuda_request_without_card_raises(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for req in (None, "cuda", torch.device("cuda", 0)):
        with pytest.raises(RuntimeError, match="is_available"):
            device.resolve(req)
    assert device.resolve("cpu") == torch.device("cpu")
    f, ker, w = model
    with pytest.raises(RuntimeError, match="is_available"):
        convert.factors_from_arrays(flatten_model(f, joos.prepare(f, w)))
    with pytest.raises(ValueError, match="unsupported device"):
        device.resolve("meta")
