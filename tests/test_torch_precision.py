"""Single-pass TF32 stays off inside the port's entry points
(``repro_torch.precision``; ROADMAP C11).

The flags are process state: a caller who runs
``torch.set_float32_matmul_precision("high")`` (or leaves cuDNN's TF32 on,
its default) would otherwise send every plain-torch float32 product of the
fit, the solves, the predictions (the routing projections of a query
included, so a query near a split could change leaf) and the SSD scan
through TF32 on the card (``ssd_chunked`` is guarded too: chip_smoke.py
calls it directly).  On the CPU the
flags change no result, so these tests read them: a stage of ``krr.fit``
sees them off while it runs, and the caller's values come back after the
call, also when the call raises.  Each test restores the process's flags.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import precision
from repro_torch.core import gp, hmatrix, kpca, krr, oos
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.models import ssm
from repro_torch.serving.predict_service import PredictEngine
from repro_torch.serving.serve_loop import ServeSession


@pytest.fixture
def tf32_on():
    """TF32 allowed for cuBLAS (through the global precision flag) and for
    cuDNN while the test runs; the process's settings back after it."""
    matmul = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision(matmul)
    torch.backends.cudnn.allow_tf32 = cudnn


def _flags():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cudnn.allow_tf32)


def _fit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 3))
    return krr.fit(x, np.sin(x).sum(axis=1), kernel=BaseKernel(
        "gaussian", 1.5, 1e-8), lam=1e-2, rank=8, leaf_size=16, device="cpu")


@pytest.mark.parametrize("fn", [
    krr.fit, krr.fit_streaming, krr.fit_incremental, krr.fit_path,
    krr.fit_exact, gp.mle_grid,
    gp.fit_gp, kpca.kpca_fit, ServeSession.prefill, ServeSession.decode,
    ssm.ssd_chunked, krr.HCKRegressor.predict, krr.HCKRegressor.predict_class,
    krr.ExactKRR.predict, krr.ExactKRR.predict_class, PredictEngine.apply,
    kpca.KPCAModel.transform],
    ids=lambda fn: fn.__qualname__)
def test_entry_points_run_in_full_f32(fn):
    assert getattr(fn, "full_f32", False), fn.__qualname__


def test_a_stage_sees_tf32_off_and_the_flags_come_back(tf32_on, monkeypatch):
    seen = []
    inner = hmatrix.invert_with_leaf

    def spy(*args, **kwargs):
        seen.append(_flags())
        return inner(*args, **kwargs)

    monkeypatch.setattr(hmatrix, "invert_with_leaf", spy)
    model = _fit()
    assert seen == [("highest", False)]
    assert _flags() == ("high", True)
    assert bool(torch.isfinite(model.alpha).all())


def test_a_prediction_sees_tf32_off_and_the_flags_come_back(tf32_on,
                                                           monkeypatch):
    model = _fit()
    seen = []
    inner = oos.apply_plan

    def spy(*args, **kwargs):
        seen.append(_flags())
        return inner(*args, **kwargs)

    monkeypatch.setattr(oos, "apply_plan", spy)
    rng = np.random.default_rng(1)
    z = model.predict(torch.as_tensor(rng.standard_normal((8, 3))))
    assert seen == [("highest", False)]
    assert _flags() == ("high", True)
    assert z.shape == (8,) and bool(torch.isfinite(z).all())


def test_the_flags_come_back_when_the_call_raises(tf32_on, monkeypatch):
    def fail(*args, **kwargs):
        assert _flags() == ("highest", False)
        raise FloatingPointError("stage failed")

    monkeypatch.setattr(hmatrix, "invert_with_leaf", fail)
    with pytest.raises(FloatingPointError, match="stage failed"):
        _fit()
    assert _flags() == ("high", True)


def test_full_f32_leaves_full_precision_untouched():
    """With TF32 already off, nothing is set or restored; nested uses keep
    it off."""
    before = _flags()
    torch.backends.cudnn.allow_tf32 = False
    try:
        with precision.full_f32():
            with precision.full_f32():
                assert _flags() == ("highest", False)
            assert _flags() == ("highest", False)
        assert _flags() == ("highest", False)
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


def test_full_f32_across_threads_keeps_full_precision(tf32_on):
    """Two threads whose calls overlap (A enters, B enters, A exits, B
    exits): TF32 stays off inside B after A left, and the caller's setting
    comes back only when the last call is out."""
    import threading

    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def thread_a():
        with precision.full_f32():
            seen["a"] = _flags()
            a_in.set()
            b_in.wait(30)
        a_out.set()

    def thread_b():
        a_in.wait(30)
        with precision.full_f32():
            seen["b_enter"] = _flags()
            b_in.set()
            a_out.wait(30)
            seen["b_after_a_left"] = _flags()

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert seen == dict.fromkeys(("a", "b_enter", "b_after_a_left"),
                                 ("highest", False))
    assert _flags() == ("high", True)
    assert precision._depth == 0 and precision._undo == []


MIXED_FLAGS = r'''
import warnings
import torch
from repro_torch import precision

warnings.simplefilter("ignore")
b = torch.backends
# cuBLAS: the global flag then the per-backend one; reading the global
# precision now raises, and TF32 is off in effect
torch.set_float32_matmul_precision("high")
b.cuda.matmul.allow_tf32 = False
# cuDNN: TF32 on through the per-backend flag; the global one now raises
b.cudnn.allow_tf32 = False
b.cudnn.conv.fp32_precision = "tf32"
for get in (torch.get_float32_matmul_precision, lambda: b.cudnn.allow_tf32):
    try:
        get()
        raise SystemExit("expected a mixed-flag state")
    except RuntimeError:
        pass
with precision.full_f32():
    inside = (b.cuda.matmul.fp32_precision, b.cudnn.conv.fp32_precision)
after = (b.cuda.matmul.fp32_precision, b.cudnn.conv.fp32_precision)
print(inside, after)
'''


def test_full_f32_with_the_per_backend_flags():
    """A caller who mixed the global and the per-backend TF32 flags (the
    global getters then raise): full_f32 reads and sets the per-backend
    ones instead, and puts them back.  Run in a process of its own, since
    such a state cannot be undone through the global flags."""
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", MIXED_FLAGS],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == (
        "('ieee', 'ieee') ('ieee', 'tf32')"), out.stdout
