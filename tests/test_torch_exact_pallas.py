"""Port parity, continued from ``test_torch_exact.py``: exact-kernel KRR
against the reference's Pallas route, and the float32 solve of the
structured inverse (ROADMAP C4).

These are the slow half of the exact-solver slice's tests: the fits of
every case under the reference's Pallas kernels in interpret mode, and a
float32 fit at covtype's width.  They sit in a file of their own so that a
scheduler that gives each file one worker runs them beside the other
half.  The cases, sizes and tolerances are ``test_torch_exact.py``'s; its
two tests of the fits are collected here again against this file's
``exact_fits``.
"""
import math

import pytest
import torch
from test_torch_exact import (  # noqa: F401 (collected here again)
    fit_cases, test_fit_exact_carried_across,
    test_fit_exact_matches_reference)

from repro_torch.core import hmatrix, krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import pad_points

@pytest.fixture(scope="module", params=["pallas"])
def exact_fits(request, f64):
    """Per case: (reference model, port model fitted on the CPU, queries)."""
    return fit_cases(request.param)


# ---------------------------------------------------------------------------
# ROADMAP C4: the float32 structured-inverse solve at covtype width
# ---------------------------------------------------------------------------

def test_f32_fit_solves_at_covtype_width():
    """krr.fit in float32 on the CPU at n = 116,000 (padded to 131,072),
    covtype's width and chip_smoke.py's synthetic data: the residual
    ||(K_hck + lam I) alpha - y|| / ||y|| through the port's own f32 matvec
    reaches the f32 floor, eps32 ||K_hck 1|| / ||1||.  The explicit
    inverse blocks (the reference's xla route) reach 1.12e-2 here, 7x
    above that floor; the fused leaf_solve route that apply_inverse now
    takes reaches ~3e-5."""
    n, d, classes = 116_000, 54, 7
    gen = torch.Generator().manual_seed(0)
    g = torch.randn((d, classes), generator=gen)
    x = math.sqrt(2.0 / d) * torch.randn((n, d), generator=gen)
    t = x @ g
    labels = torch.argmax(torch.sin(3.0 * t) + 0.5 * t * t, dim=1)
    model = krr.fit(x, labels, kernel=BaseKernel("gaussian", 1.0, 1e-5),
                    lam=1e-2, rank=128, classification=True, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    f = model.factors
    assert f.n == 131_072 and f.levels == 10 and model.alpha.dtype == \
        torch.float32
    # targets in tree order, the padding rows copying their sources'
    targets = torch.where(labels[:, None] == torch.arange(classes), 1.0, -1.0)
    _, y_pad, _ = pad_points(x, targets, 128, 10,
                             generator=torch.Generator().manual_seed(1))
    y_sorted = y_pad[f.tree.perm]
    resid = y_sorted - hmatrix.matvec(f, model.alpha) - 1e-2 * model.alpha
    rel = float(torch.linalg.vector_norm(resid)
                / torch.linalg.vector_norm(y_sorted))
    ones = torch.ones((f.n, 1))
    floor = torch.finfo(torch.float32).eps * float(
        torch.linalg.vector_norm(hmatrix.matvec(f, ones)) / math.sqrt(f.n))
    assert rel <= floor, (rel, floor)
