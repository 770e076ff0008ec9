"""Time the float32 entries of B1 ``gram_chol_levels``, B2
``cross_solve_levels``, B7 ``oos_contract`` (both terms of a bucket in one
launch), B8 ``gram_chol_dist_levels`` (and ``gram_dist``) and B9
``cross_solve_dist_levels`` of the checkout this file lives in, on one
card, and their bfloat16-data entries where the checkout has them.

Builds the libraries from the checkout's sources, fits the covtype-width
model of ``chip_smoke.py`` phase 3 (synthetic, seeded), draws its sweep
plan, and times each kernel at that path's shapes as ``chip_smoke.py``
phase 9 does: events around calls for B1, B2, B8 and B9, device time
(calls queued behind a spin kernel) for B7.  Prints one JSON line of the
times in ms.  To compare two checkouts, run it from both in turns (a, b,
b, a) in one session on the card:

    python3 tools/time_contract_build.py
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import krr
    from repro_torch.core.hck import build_sweep_plan, sweep_factors
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.core.partition import pad_points
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.oos_stage import ops as oops

    _build.build(tuple(n for n in _build.KERNELS if n in (
        "build_stage", "build_dist", "oos_contract", "leaf_factor",
        "leaf_solve", "leaf_matvec", "hck_leaf_project", "build_stage_bf16",
        "build_dist_bf16", "oos_contract_bf16")))
    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x, labels, xt, _ = cs.make_data(cs.N_TRAIN, cs.N_TEST, dev, gen)
    ker = BaseKernel("gaussian", cs.SIGMA, cs.JITTER)
    model = krr.fit(x, labels, kernel=ker, lam=cs.LAM, rank=cs.RANK,
                    leaf_size=cs.LEAF, classification=True,
                    generator=torch.Generator(device=dev).manual_seed(
                        cs.SEED + 1))
    f = model.factors
    args = cs.fit_launches(f, model.inverse, model.alpha.view(
        f.num_leaves, cs.LEAF, cs.N_CLASSES))
    pair = cs.bucket_inputs(f, model.plan, xt[:4096])[2]
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    xp, _, _ = pad_points(x, labels, cs.LEAF, cs.LEVELS, generator=g)
    plan = build_sweep_plan(xp, levels=cs.LEVELS, rank=cs.RANK, generator=g)
    sweep = cs.sweep_launches(plan, sweep_factors(plan, ker))
    opts = dict(sigma=cs.SIGMA, jitter=cs.JITTER)
    variants = [("f32", lambda t: t)]
    if "build_stage_bf16" in _build.KERNELS:
        variants.append(("bf16 data", lambda t: t.to(torch.bfloat16)))
    out = {"card": cs.card(), "checkout": str(ROOT)}
    for tag, data in variants:
        pts = [data(p) for p, _ in args["gram"]]
        cross = [(data(p), data(z), li) for p, z, li in args["cross"]]
        bucket = (data(pair[0]), pair[1], data(pair[2]), pair[3],
                  data(pair[4]), *pair[5:])
        sig = [data(d) for d in sweep["sigma"]]
        adiag = data(sweep["adiag"])
        cd = [(data(d), li) for d, li in sweep["cross"]]
        out[tag] = {
            "B1": cs.time_ms(lambda: (
                bops.build_gram_levels(pts[:-1], **opts),
                bops.build_gram(pts[-1], want_chol=False, **opts)), 10),
            "B2": cs.time_ms(lambda: bops.build_cross_levels(
                *zip(*cross), sigma=cs.SIGMA), 10),
            "B7": cs.device_ms(lambda: oops.oos_local_walk(
                *bucket, sigma=cs.SIGMA), 50),
            "B8": cs.time_ms(lambda: (
                bops.build_gram_dist_levels(sig, **opts),
                bops.build_gram_dist(adiag, want_chol=False, **opts)), 10),
            "B9": cs.time_ms(lambda: bops.build_cross_dist_levels(
                *zip(*cd), sigma=cs.SIGMA), 10)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
