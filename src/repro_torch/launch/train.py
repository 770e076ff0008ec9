"""Training launcher of the port (counterpart of ``repro.launch.train``).

``--task krr``: fit an HCK kernel ridge model through the build engine,
the stage backends chosen by ``--solve-backend`` (one SolveConfig threads
the build, the solve and the predictions); ``--stream`` ingests through
the chunked host-resident pipeline (:mod:`repro_torch.data.pipeline`,
``krr.fit_streaming``, ``--leaf-batch`` leaves a launch) instead of a
device-resident array:

  PYTHONPATH=src python -m repro_torch.launch.train --task krr \\
      --n 65536 --rank 128 --stream

``--update N``: after the fit, absorb N new points online (frozen-tree
routing, bordered leaf-factor refresh, the structured re-solve:
``model.update``) and report inserts/s against the fit's points/s.

``--solver exact-cg|eigenpro``: exact-kernel KRR through the matvec-free
iterative solvers (``krr.fit_exact``): HCK-preconditioned CG, or EigenPro.

``--grid``: a sigma x lambda search through the sweep engine -- one
partition and distance pass (``build_sweep_plan``), per sigma one factor
instantiation (``sweep_factors``) and the whole lambda axis through
``krr.fit_path``, scored on a validation set:

  PYTHONPATH=src python -m repro_torch.launch.train --task krr --grid \\
      --n 16384 --rank 64 --sigmas 0.5,1,2,4 --lams 1e-4,1e-3,1e-2,1e-1

``--precision bf16|f32|f64`` sets the mixed-precision policy of the
build, the solve and the predictions (``SolveConfig.precision``); bf16
runs at the reference's convention of jitter 1e-4 and lambda 1e-1 (the
ridge floor of bf16-built factors), the others at jitter 1e-5 and lambda
1e-2.

Runs on the card unless ``--device cpu``; without a card the default
raises.  The data are random, drawn from ``--seed``.  Not yet ported, each
raising ``NotImplementedError``: ``--task lm`` (ROADMAP item A16b, which
also brings the LM flags: ``--arch``, ``--steps`` and the rest) and
``--mesh`` (A14).  On the card every precision takes ranks up to 256 and
leaves (grown by ``--update`` too) up to 512 rows, the limits of the
kernels' panel forms; past them the build kernels raise their own error.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as _device


def _solve_config(args):
    """SolveConfig from --solve-backend and --precision."""
    from repro_torch.kernels.registry import SolveConfig

    return SolveConfig(backend=args.solve_backend,
                       precision=None if args.precision == "none"
                       else args.precision)


def _target(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x[:, 0]) + 0.25 * torch.cos(2.0 * x[:, 1])


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def run_krr(args) -> dict:
    """Fit and evaluate an HCK KRR model (in memory, streamed, or by an
    exact-kernel solver), then the optional online update; print the
    reference's lines.  Returns the times, errors and the model."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel

    cfg = _solve_config(args)
    dev = _device.resolve(args.device)
    x = torch.randn((args.n, args.d), device=dev,
                    generator=_generator(dev, args.seed))
    y = _target(x)
    # bf16 rounds a 1e-5 jitter off the unit Gram diagonal (eps_bf16 ~
    # 8e-3), so the leaf Cholesky needs the larger lambda' split, and the
    # inversion of bf16-built factors a ridge near n0 * eps_bf16
    # (SolveConfig.precision)
    bf16 = args.precision == "bf16"
    ker = BaseKernel("gaussian", sigma=2.0, jitter=1e-4 if bf16 else 1e-5)
    lam = 1e-1 if bf16 else 1e-2
    m = min(args.n, 2048)

    if args.solver in ("exact-cg", "eigenpro"):
        # exact-kernel KRR: the HCK hierarchy only preconditions CG (or
        # EigenPro's truncated spectrum does); K(X, X) is never formed
        _device.synchronize(dev)
        t0 = time.perf_counter()
        model = krr.fit_exact(
            x, y, kernel=ker, lam=lam, rank=args.rank, solve_config=cfg,
            solver="cg" if args.solver == "exact-cg" else "eigenpro",
            tol=1e-4, maxiter=args.cg_maxiter, device=dev,
            generator=_generator(dev, args.seed + 1))
        _device.synchronize(dev)
        t_fit = time.perf_counter() - t0
        err = float(krr.relative_error(model.predict(x[:m]), y[:m]))
        it = int(model.result.iterations)
        res = float(model.result.residuals[it])
        print(f"krr-exact n={args.n} d={args.d} rank={args.rank} "
              f"solver={args.solver} backend={args.solve_backend}: "
              f"fit {t_fit:.2f} s in {it} iterations "
              f"(rel resid {res:.2e}), train rel-err {err:.4f}")
        return {"mode": args.solver, "fit_s": t_fit, "iterations": it,
                "residual": res, "train_rel_err": err, "model": model}

    _device.synchronize(dev)
    t0 = time.perf_counter()
    if args.stream:
        from repro_torch.data.pipeline import ArraySource

        model = krr.fit_streaming(
            ArraySource(x), y, kernel=ker, lam=lam, rank=args.rank,
            solve_config=cfg, leaf_batch=args.leaf_batch,
            landmarks=args.landmarks, rank_budget=args.rank_budget,
            device=dev, generator=_generator(dev, args.seed + 1))
    else:
        model = krr.fit(x, y, kernel=ker, lam=lam, rank=args.rank,
                        solve_config=cfg, landmarks=args.landmarks,
                        rank_budget=args.rank_budget, device=dev,
                        generator=_generator(dev, args.seed + 1))
    _device.synchronize(dev)
    t_fit = time.perf_counter() - t0
    err = float(krr.relative_error(model.predict(x[:m]), y[:m]))
    mode = "streaming" if args.stream else "in-memory"
    print(f"krr n={args.n} d={args.d} rank={args.rank} "
          f"backend={args.solve_backend} ({mode}): fit {t_fit:.2f} s "
          f"({args.n / t_fit:,.0f} points/s), train rel-err {err:.4f}")
    out = {"mode": mode, "fit_s": t_fit, "train_rel_err": err,
           "precision": args.precision, "model": model}

    if args.update:
        # online growth: absorb --update new points into the fitted
        # hierarchy (frozen tree, bordered leaf refresh, re-solve) instead
        # of rebuilding
        xu = torch.randn((args.update, args.d), device=dev,
                         generator=_generator(dev, args.seed + 11))
        yu = _target(xu)
        _device.synchronize(dev)
        t0 = time.perf_counter()
        model2, info = model.update(
            xu, yu, generator=_generator(dev, args.seed + 12))
        _device.synchronize(dev)
        t_upd = time.perf_counter() - t0
        err2 = float(krr.relative_error(model2.predict(x[:m]), y[:m]))
        print(f"krr-update +{args.update} points: {t_upd:.2f} s "
              f"({args.update / t_upd:,.0f} inserts/s vs full fit "
              f"{args.n / t_fit:,.0f} points/s), k={info.record.k}/leaf, "
              f"resid {info.residual:.2e}, rebuild={info.needs_rebuild}, "
              f"train rel-err {err2:.4f}")
        out.update(update_s=t_upd, update_k=info.record.k,
                   update_residual=info.residual,
                   update_rel_err=err2, updated=model2)
    return out


def run_krr_grid(args) -> dict:
    """sigma x lambda grid search through the sweep engine (SweepPlan +
    fit_path); print the reference's lines.  Returns the times, the score
    surface and the selected (sigma, lambda)."""
    from repro_torch.core import krr
    from repro_torch.core.hck import build_sweep_plan, sweep_factors
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.core.partition import auto_levels_ceil, pad_points

    cfg = _solve_config(args)
    dev = _device.resolve(args.device)
    sigmas = [float(s) for s in args.sigmas.split(",")]
    lams = [float(v) for v in args.lams.split(",")]
    x = torch.randn((args.n, args.d), device=dev,
                    generator=_generator(dev, args.seed))
    y = _target(x)
    xv = torch.randn((args.val, args.d), device=dev,
                     generator=_generator(dev, args.seed + 7))
    yv = _target(xv)
    # the sizing and padding rule of krr.fit, so any --n works
    levels = max(1, auto_levels_ceil(args.n, args.rank))
    x, y, _ = pad_points(x, y, args.rank, levels,
                         generator=_generator(dev, args.seed + 3))

    _device.synchronize(dev)
    t0 = time.perf_counter()
    plan = build_sweep_plan(x, levels=levels, rank=args.rank,
                            policy=args.landmarks, config=cfg, device=dev,
                            generator=_generator(dev, args.seed + 1))
    _device.synchronize(dev)
    t_plan = time.perf_counter() - t0

    # per sigma: one factor instantiation, then the whole lambda axis
    # through fit_path (multi-ridge inversion + one scored OOS pass)
    paths = []
    t0 = time.perf_counter()
    for s in sigmas:
        ker = BaseKernel("gaussian", sigma=s)
        factors = sweep_factors(plan, ker, cfg, rank_budget=args.rank_budget)
        paths.append(krr.fit_path(
            x, y, kernel=ker, lams=lams, solve_config=cfg, factors=factors,
            x_val=xv, y_val=yv, device=dev))
    _device.synchronize(dev)
    t_grid = time.perf_counter() - t0

    n_pts = len(sigmas) * len(lams)
    print(f"sweep n={x.shape[0]} rank={args.rank} grid={len(sigmas)}x"
          f"{len(lams)} backend={args.solve_backend}: "
          f"plan {t_plan:.2f} s + grid {t_grid:.2f} s "
          f"({n_pts / (t_plan + t_grid):.2f} grid points/s)")
    surface = [[float(e) for e in path.scores] for path in paths]
    for s, row in zip(sigmas, surface):
        print(f"  sigma={s:<8g} val-relerr per lam: "
              + "  ".join(f"{e:.4f}" for e in row))
    i_best = min(range(len(sigmas)), key=lambda i: min(surface[i]))
    g_best = min(range(len(lams)), key=lambda g: surface[i_best][g])
    model = paths[i_best].best()
    err = float(krr.relative_error(model.predict(xv), yv))
    print(f"best: sigma={sigmas[i_best]} lam={lams[g_best]} "
          f"val-relerr {err:.4f}")
    return {"plan_s": t_plan, "grid_s": t_grid, "surface": surface,
            "sigma": sigmas[i_best], "lam": lams[g_best],
            "val_rel_err": err}


def main(argv=None):
    """Parse the arguments and run the task."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["lm", "krr"], default="krr",
                    help="'lm' raises until ROADMAP item A16b ports LM "
                    "training, which brings back its flags")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and of every draw of the fit")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--d", type=int, default=8)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--solve-backend", choices=["auto", "torch", "cuda"],
                    default="auto", help="SolveConfig backend of the build, "
                    "the solve and the predictions: 'auto' follows the "
                    "device (the CUDA kernels on the card, the plain "
                    "versions on the CPU)")
    ap.add_argument("--precision", choices=["none", "bf16", "f32", "f64"],
                    default="none",
                    help="mixed-precision policy of the build, the solve "
                    "and the predictions (SolveConfig.precision; 'none' "
                    "keeps the input dtype)")
    ap.add_argument("--solver", choices=["hck", "exact-cg", "eigenpro"],
                    default="hck",
                    help="'hck' = structured Algorithm-2 solve on the "
                    "approximate kernel; 'exact-cg' = HCK-preconditioned CG "
                    "on the exact kernel (matvec-free); 'eigenpro' = "
                    "truncated-eigenspectrum preconditioned Richardson")
    ap.add_argument("--cg-maxiter", type=int, default=300,
                    help="iteration cap for --solver exact-cg/eigenpro")
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard over this many devices (ROADMAP item A14)")
    ap.add_argument("--stream", action="store_true",
                    help="ingest through the chunked host-resident pipeline")
    ap.add_argument("--update", type=int, default=0,
                    help="after the fit, absorb this many new points online "
                    "and report inserts/s against the fit's points/s "
                    "(0 = off)")
    ap.add_argument("--leaf-batch", type=int, default=64,
                    help="leaves staged per device launch when streaming")
    ap.add_argument("--landmarks", choices=["uniform", "kmeans", "leverage"],
                    default="uniform",
                    help="landmark-selection policy of the build")
    ap.add_argument("--rank-budget", type=int, default=None,
                    help="global rank budget (sum of the per-node ranks); "
                    "default: full rank everywhere")
    ap.add_argument("--grid", action="store_true",
                    help="sigma x lambda grid search through the sweep "
                    "engine")
    ap.add_argument("--sigmas", default="0.5,1,2,4",
                    help="comma-separated bandwidth grid (with --grid)")
    ap.add_argument("--lams", default="1e-4,1e-3,1e-2,1e-1",
                    help="comma-separated ridge grid (with --grid)")
    ap.add_argument("--val", type=int, default=2048,
                    help="validation points for --grid scoring")
    args = ap.parse_args(argv)

    if args.task == "lm":
        raise NotImplementedError(
            "LM training (--task lm) comes with ROADMAP item A16b; the "
            "port serves LMs through repro_torch.launch.serve")
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the mesh-parallel build, solve and serving come with "
            "ROADMAP item A14 (distributed)")
    if args.grid:
        return run_krr_grid(args)
    return run_krr(args)


if __name__ == "__main__":
    main()
