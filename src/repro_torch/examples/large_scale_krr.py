"""End-to-end run of the paper's own workload: large-scale HCK kernel
ridge classification (the SUSY/covtype regime of Table 1, synthetic
stand-in; counterpart of the reference's ``examples/large_scale_krr.py``).

    PYTHONPATH=src python -m repro_torch.examples.large_scale_krr
    PYTHONPATH=src python -m repro_torch.examples.large_scale_krr \\
        --n 4000000 --n-test 1000000 --stream     # the susy row's size

Runs the whole O(n r^2) pipeline -- random-projection partition, factor
instantiation, Algorithm-2 inversion, Algorithm-3 batched prediction --
and reports the wall times (cf. the paper's section 5.3 timing plots).
``--stream`` fits from a host-resident source through
``krr.fit_streaming`` instead of ``krr.fit``.  Runs on the card unless
``--device cpu``; the data are drawn from ``--seed``
(:func:`repro_torch.data.pipeline.regression_dataset`).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device
from repro_torch.configs.hck_krr import HCKConfig
from repro_torch.core import krr
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.data.pipeline import ArraySource, regression_dataset


def dataset(cfg: HCKConfig, *, device=None, seed: int = 0):
    """``regression_dataset(cfg)`` from a generator seeded ``seed`` on
    ``device`` (None = the card): ((x, y), (x_test, y_test))."""
    dev = _device.resolve(device)
    return regression_dataset(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed))


def fit(x, y, *, rank: int, lam: float, sigma: float, seed: int = 1,
        stream: bool = False, leaf_batch: int = 64,
        chunk_rows: int = 1 << 16, timings: dict | None = None):
    """The example's classifier on (x, y), on x's device: ``krr.fit``, or
    with ``stream`` ``krr.fit_streaming`` over the rows held on the host;
    both draw from a generator seeded ``seed``, so they pad, partition and
    pick landmarks alike.  ``timings``, a dict, receives the stages' wall
    seconds."""
    dev = x.device
    opts = dict(kernel=BaseKernel("gaussian", sigma=sigma), lam=lam,
                rank=rank, classification=True, device=dev, timings=timings,
                generator=torch.Generator(device=dev).manual_seed(seed))
    if stream:
        return krr.fit_streaming(ArraySource(x), y, leaf_batch=leaf_batch,
                                 chunk_rows=chunk_rows, **opts)
    return krr.fit(x, y, **opts)


def main(argv=None) -> dict:
    """Draw the data, fit, predict the test set; print the reference's
    lines.  Returns the times, the accuracy and the model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--n-test", type=int, default=None,
                    help="test points (default n // 8)")
    ap.add_argument("--d", type=int, default=18)
    ap.add_argument("--rank", type=int, default=128)
    ap.add_argument("--lam", type=float, default=1e-2)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--stream", action="store_true",
                    help="fit through krr.fit_streaming")
    ap.add_argument("--leaf-batch", type=int, default=64,
                    help="leaves staged per device launch when streaming")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    n_test = args.n_test if args.n_test is not None else args.n // 8
    cfg = HCKConfig("susy-like", n_train=args.n, n_test=n_test, d=args.d,
                    task="binary")
    (x, y), (xt, yt) = dataset(cfg, device=dev, seed=args.seed)

    _device.synchronize(dev)
    t0 = time.perf_counter()
    model = fit(x, y, rank=args.rank, lam=args.lam, sigma=args.sigma,
                seed=args.seed + 1, stream=args.stream,
                leaf_batch=args.leaf_batch)
    _device.synchronize(dev)
    t_fit = time.perf_counter() - t0

    t0 = time.perf_counter()
    pred = model.predict_class(xt)
    _device.synchronize(dev)
    t_pred = time.perf_counter() - t0

    acc = float(krr.accuracy(pred, yt))
    n, r = args.n, args.rank
    print(f"n={n} d={args.d} r={r}  levels={model.factors.levels}")
    print(f"train (O(nr^2) = {n*r*r/1e9:.1f} Gflop-units): {t_fit:.2f}s")
    print(f"predict {len(yt)} pts (O(r^2 log) each):       {t_pred:.2f}s "
          f"({t_pred/len(yt)*1e6:.1f} us/query)")
    print(f"test accuracy: {acc:.4f}")
    print(f"memory (factors ~4nr floats): {4*n*r*4/1e9:.2f} GB")
    return {"fit_s": t_fit, "predict_s": t_pred, "accuracy": acc,
            "model": model}


if __name__ == "__main__":
    main()
