"""Quickstart: hierarchically compositional kernel ridge regression on the
port (counterpart of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Fits HCK-KRR on a synthetic regression task, compares it with the
Nystrom, RFF, independent and exact baselines at equal rank, and shows
the GP view (posterior variance and the log marginal likelihood through
the structured log-determinant).  Runs on the card unless ``--device
cpu``; the data are drawn from ``--seed``.  :func:`run` takes the data
and, optionally, each fit's random draws (the tests give it the
reference's, to hold every reading against the reference's quickstart).
The reference's second
example, ``gp_mle.py``, waits for ROADMAP A8b: it differentiates
``mle_objective``, and the kernels refuse gradients.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as _device
from repro_torch.core import baselines, gp, krr
from repro_torch.core.kernels_fn import BaseKernel


def target(x: torch.Tensor) -> torch.Tensor:
    """The reference's function: sin(6 x0) cos(4 x1) + x2^2."""
    return torch.sin(6 * x[:, 0]) * torch.cos(4 * x[:, 1]) + x[:, 2] ** 2


def run(x, y, xt, yt, *, device, gen=None, draws=None) -> dict:
    """The quickstart's fits on ``x``, ``y``, scored on ``xt``, ``yt``;
    prints the reference's lines and returns the relative test errors
    ("hck", "nystrom", "rff", "independent", "exact") and the GP readings
    ("gp_var", "gp_lml").  Each fit's random draws come from
    ``draws[fit]`` (keyword arguments of its function: "hck", "nystrom",
    "rff", "independent", "gp") where given, else from ``gen(seed)``, the
    reference's seeds 7 to 11."""
    draws = draws or {}

    def rnd(fit, seed):
        return draws[fit] if fit in draws else {"generator": gen(seed)}

    n, d = x.shape
    ker = BaseKernel("gaussian", sigma=0.7)
    lam, rank = 1e-2, min(64, n // 8)
    out = {}
    print(f"n={n} d={d} rank={rank}  (memory ~4nr = "
          f"{4 * n * rank * 4 / 1e6:.1f} MB)")
    m = krr.fit(x, y, kernel=ker, lam=lam, rank=rank, device=device,
                **rnd("hck", 7))
    out["hck"] = float(krr.relative_error(m.predict(xt), yt))
    print(f"HCK-KRR      rel err: {out['hck']:.4f}")
    ny = baselines.fit_nystrom(x, y, kernel=ker, lam=lam, rank=rank,
                               device=device, **rnd("nystrom", 8))
    out["nystrom"] = float(krr.relative_error(ny.predict(xt)[:, 0], yt))
    print(f"Nystrom      rel err: {out['nystrom']:.4f}")
    rf = baselines.fit_rff(x, y, kernel=ker, lam=lam, rank=rank,
                           device=device, **rnd("rff", 9))
    out["rff"] = float(krr.relative_error(rf.predict(xt)[:, 0], yt))
    print(f"RFF          rel err: {out['rff']:.4f}")
    ind = baselines.fit_independent(x, y, kernel=ker, lam=lam, levels=6,
                                    device=device, **rnd("independent", 10))
    out["independent"] = float(krr.relative_error(ind.predict(xt), yt))
    print(f"independent  rel err: {out['independent']:.4f}")
    ex = baselines.fit_exact(x, y, kernel=ker, lam=lam, device=device)
    out["exact"] = float(krr.relative_error(ex(xt), yt))
    print(f"exact (n^3)  rel err: {out['exact']:.4f}")

    # GP view: posterior mean and variance, and the marginal likelihood at
    # O(n r^2)
    ng = min(1024, n)
    grp = gp.fit_gp(x[:ng], y[:ng], kernel=ker, noise=lam,
                    rank=min(64, ng // 8), levels=3, device=device,
                    **rnd("gp", 11))
    var = grp.posterior_var(xt[:4])
    lml = grp.log_marginal_likelihood(y[:ng][grp.factors.tree.perm])
    out["gp_var"] = [float(v) for v in var]
    out["gp_lml"] = float(lml)
    print(f"GP posterior var (4 queries): "
          f"{[round(v, 4) for v in out['gp_var']]}")
    print(f"GP log marginal likelihood:   {out['gp_lml']:.1f}")
    return out


def main(argv=None) -> dict:
    """Draw the reference's task from ``--seed`` and :func:`run` it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n, d = args.n, args.d
    gen = lambda s: torch.Generator(device=dev).manual_seed(  # noqa: E731
        args.seed + s)
    g = gen(0)
    x = torch.rand((n, d), generator=g, device=dev)
    y = target(x) + 0.05 * torch.randn((n,), generator=g, device=dev)
    xt = torch.rand((1024, d), generator=g, device=dev)
    return run(x, y, xt, target(xt), device=dev, gen=gen)


if __name__ == "__main__":
    main()
