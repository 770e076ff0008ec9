"""ROADMAP C15 on the CPU: where the float32 HCK solve leaves its noise
floor, the reference's does too, and a float64 solve of the same factors
does not.

At the ``susy`` row's full size (4,000,000 points, sigma 1, lambda 1e-2)
eps32 ||K|| ||alpha|| / ||y|| is about 1, and the f32 fit's residual
||(K + lam I) alpha - y|| / ||y|| stays far above the floor eps32 ||K 1|| /
||1|| on the card.  That size does not fit a CPU test, so this file takes
the same data generator at the susy row's width (``regression_dataset``,
d 18, binary) at 8,192 points with a wider kernel and a smaller ridge
(sigma 4, lambda 1e-4), where the f32 solve falls short of the floor by
two to three orders of magnitude.  The reference fits in float32 on its
Pallas route (interpret mode), the port in float32 on the CPU with the
reference's directions and landmark rows; each residual is taken in
float64 against its own factors.  The port's f32 factors, cast to
float64, are then inverted and solved in float64: that solve meets the
floor, and both f32 alphas lie within ``chip_smoke.SUSY_FWD`` of it, the
gate phase 3s puts on the card's 4,000,000-point fit, where the float64
solve does not fit in memory and alpha refined in float64 (flexible PCG,
the f32 inverse as preconditioner) stands in for it; here the refined
alpha equals the float64 solve's.  ``-s`` prints the readings.
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_build import landmark_draws

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repo's root: SUSY_FWD, to_f64)
from repro.core import hmatrix as jhm  # noqa: E402
from repro.core import krr as jkrr
from repro.core.kernels_fn import BaseKernel as JKernel
from repro.kernels.registry import SolveConfig as JSolveConfig
from repro_torch.configs.hck_krr import DATASETS, HCKConfig
from repro_torch.core import hmatrix, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.data.pipeline import regression_dataset
from repro_torch.solvers.cg import pcg

N, N_TEST, SIGMA, LAM, RANK = 8192, 4096, 4.0, 1e-4, 128
EPS32, EPS64 = (torch.finfo(t).eps for t in (torch.float32, torch.float64))


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a) / torch.linalg.vector_norm(b))


@pytest.fixture(scope="module")
def fits(f64):
    row = DATASETS["susy"]
    (x, y), (xt, yt) = regression_dataset(
        HCKConfig("susy-analog", N, N_TEST, row.d, row.task),
        generator=torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(1)
    jm = jkrr.fit(jnp.asarray(x.numpy(), dtype=jnp.float32),
                  jnp.asarray(y.numpy()), kernel=JKernel("gaussian",
                                                         sigma=SIGMA),
                  lam=LAM, rank=RANK, classification=True, key=key,
                  solve_config=JSolveConfig(backend="pallas"))
    jf = jm.factors
    _, kbuild = jax.random.split(key)
    model = krr.fit(x, y, kernel=BaseKernel("gaussian", SIGMA), lam=LAM,
                    rank=RANK, classification=True, device="cpu",
                    directions=[torch.from_numpy(np.array(v))
                                for v in jf.tree.directions],
                    landmark_index=landmark_draws(kbuild, N, jf.levels, RANK))
    f = model.factors
    f64 = chip_smoke.to_f64(f)
    y_sorted = torch.where(y == 1, 1.0, -1.0)[:, None][f.tree.perm].double()
    knorm = float(torch.linalg.vector_norm(hmatrix.matvec(
        f64, torch.ones((f.n, 1), dtype=torch.float64))) / math.sqrt(f.n))
    inv, _ = hmatrix.invert_with_leaf(f64, LAM)
    a64 = hmatrix.solve_with_inverse(f64, inv, y_sorted, ridge=LAM)
    # the reference's alpha against its own factors, in float64
    jf64 = jax.tree_util.tree_map(
        lambda t: t.astype(jnp.float64)
        if getattr(t, "dtype", None) == jnp.float32 else t, jf)
    ja = jnp.asarray(np.array(jm.alpha), dtype=jnp.float64)
    jy = jnp.asarray(y_sorted.numpy())
    ref_res = float(jnp.linalg.norm(
        jy - jhm.matvec(jf64, ja, JSolveConfig(backend="xla")) - LAM * ja)
        / jnp.linalg.norm(jy))
    port_a = model.alpha.double()
    # chip_smoke's refinement: flexible PCG on the float64 matvec, the
    # port's f32 inverse as preconditioner, from the f32 alpha
    cg = pcg(lambda v: hmatrix.matvec(f64, v), y_sorted, ridge=LAM,
             precond=lambda r: hmatrix.apply_inverse(
                 model.inverse, r.float()).double(),
             tol=chip_smoke.REFINE_TOL, maxiter=chip_smoke.REFINE_ITERS,
             x0=port_a)
    out = {
        "same_tree": np.array_equal(f.tree.perm.numpy(),
                                    np.array(jf.tree.perm)),
        "floor32": EPS32 * knorm,
        "port_res": _rel(y_sorted - hmatrix.matvec(f64, port_a)
                         - LAM * port_a, y_sorted),
        "ref_res": ref_res,
        "res64": _rel(y_sorted - hmatrix.matvec(f64, a64) - LAM * a64,
                      y_sorted),
        "bwd64": EPS64 * knorm * max(1.0, _rel(a64, y_sorted)),
        "port_fwd": _rel(port_a - a64, a64),
        "refined": bool(cg.converged), "refine_iters": cg.iterations,
        "refined_vs_64": _rel(cg.x - a64, a64),
        "ref_fwd": _rel(torch.from_numpy(np.array(ja)) - a64, a64),
        "port_acc": float(krr.accuracy(model.predict_class(xt), yt)),
        "ref_acc": float(jkrr.accuracy(
            jm.predict_class(jnp.asarray(xt.numpy(), dtype=jnp.float32)),
            jnp.asarray(yt.numpy()))),
    }
    print("\nC15 analog:", {k: (f"{v:.3e}" if isinstance(v, float) else v)
                            for k, v in out.items()})
    return out


def test_port_and_reference_share_the_tree(fits):
    assert fits["same_tree"]


def test_f64_solve_of_the_same_factors_meets_the_floor(fits):
    assert fits["res64"] <= fits["floor32"], fits
    assert fits["res64"] <= fits["bwd64"], fits


def test_f32_solve_falls_short_in_both_packages(fits):
    """The shortfall is the reference's too: both f32 residuals stand far
    above eps32 ||K 1|| / ||1|| on the same system."""
    assert fits["port_res"] > 10 * fits["floor32"], fits
    assert fits["ref_res"] > 10 * fits["floor32"], fits


def test_f64_refinement_reaches_the_f64_solve(fits):
    """Phase 3s's gate on the card, where the float64 solve does not fit:
    the refined alpha stands in for it."""
    assert fits["refined"], fits
    assert fits["refined_vs_64"] <= 1e-8, fits


def test_f32_alphas_within_the_chip_gate_of_the_f64_solve(fits):
    assert fits["port_fwd"] <= chip_smoke.SUSY_FWD, fits
    assert fits["ref_fwd"] <= chip_smoke.SUSY_FWD, fits
