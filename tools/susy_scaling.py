"""The float32 HCK fit of the ``susy`` stand-in at growing n, held to a
float64 solve of the same factors (ROADMAP Queue C, C15).

For each n it draws ``regression_dataset`` data of the susy row's width
(d 18, binary, the example's seed), fits the example's model (rank 128,
leaf 128, gaussian sigma 1, lambda 1e-2, ``krr.fit`` in float32) and
prints one line: the levels, the fit's wall time, the relative residual
||(K + lam I) alpha - y|| / ||y|| evaluated in float32, eps32 ||K 1|| /
||1||, ||alpha|| / ||y||, the largest kappa of Sigma at the leaves'
parents and the test accuracy on ``--n-test`` points; then
``chip_smoke.f64_witness``: alpha refined in float64 (flexible PCG on the
float64 matvec, the fit's f32 inverse as preconditioner), both alphas'
residuals through the float64 matvec, the f32 alpha's forward error
against the refined one, the share of test predictions of the same sign,
the refined alpha's test accuracy, and the float64 solve of the same
factors against the refined alpha.  On the card by default:

    python3 tools/susy_scaling.py
    python3 tools/susy_scaling.py --device cpu --sizes 16384,65536
"""
import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import device as _device  # noqa: E402
from repro_torch.configs.hck_krr import DATASETS, HCKConfig  # noqa: E402
from repro_torch.core import krr  # noqa: E402
from repro_torch.core.partition import auto_levels_ceil, pad_points  # noqa: E402,E501
from repro_torch.examples import large_scale_krr  # noqa: E402


def one_size(n: int, n_test: int, dev) -> str:
    """Fit the susy stand-in at n points; its readings as one line."""
    row = DATASETS["susy"]
    cfg = HCKConfig("susy-like", n, n_test, row.d, row.task)
    (x, y), (xt, yt) = large_scale_krr.dataset(cfg, device=dev, seed=0)
    _device.synchronize(dev)
    t0 = time.perf_counter()
    model = large_scale_krr.fit(x, y, rank=row.rank, lam=row.lam,
                                sigma=row.sigma, seed=1)
    _device.synchronize(dev)
    t_fit = time.perf_counter() - t0
    f = model.factors
    levels = auto_levels_ceil(n, row.leaf_size)
    _, yp, _ = pad_points(x, y, row.leaf_size, levels,
                          generator=torch.Generator(device=dev).manual_seed(1))
    one = torch.ones((), device=dev)
    targets = torch.where(yp == 1, one, -one)[:, None]
    r = cs.fit_floor(model, targets)
    kappa = float(torch.linalg.cond(f.sigma[-1].double()).max())
    acc = float(krr.accuracy(model.predict_class(xt), yt))
    del x, y
    w = cs.f64_witness(model, model.predict(xt), targets, xt, yt,
                       direct=True)
    return (f"n {n} (levels {f.levels}): fit {t_fit:.3f} s; residual f32 "
            f"{r['res']:.3e}; eps32 ||K 1|| / ||1|| {r['floor']:.3e}; "
            f"||alpha|| / ||y|| {r['alpha_y']:.3f}; max kappa(Sigma) at the "
            f"leaves' parents {kappa:.4e}; test accuracy {acc:.4f} on "
            f"{n_test}; {cs.witness_text(w)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="262144,1000000,2000000")
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        torch.set_float32_matmul_precision("highest")
        print(cs.card(), flush=True)
    for n in (int(v) for v in args.sizes.split(",")):
        print(one_size(n, args.n_test, dev), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
