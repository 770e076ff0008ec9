"""Time B4 ``leaf_solve`` of the checkout this file lives in under each
staging its shared memory allows (Linv's triangle and U staged or read in
place), on one card, at the rank-256 shapes: the rank-256 fit's leaves
(P 2,048, n0 256, r 256, k 7, f32), the grown leaves of an update round
at leaf 256 (n0 277, the wide instance) and the covtype fit's (P 4,096, n0
= r = 128, k 7), and in float64 the update bench's (P 256, n0 272, r 256,
k 1).  Random lower-triangular Linv of a well-conditioned leaf, U, Sig
(one block a sibling pair) and b, made from a seed.

Prints the card, then one JSON line a shape: the plan the wrapper
chooses, each staging's device time in ms (``chip_smoke.device_ms``: calls
queued behind a spin kernel) and its largest error against the plain
version (relative to its largest entry; every staging runs the same
arithmetic, so the errors agree), and the plain version's time::

    python3 tools/leaf_solve_staging.py
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.hck_leaf import ops, ref  # noqa: E402

SHAPES = ((2048, 256, 256, 7, torch.float32), (2048, 277, 256, 7,
                                                torch.float32),
          (4096, 128, 128, 7, torch.float32), (256, 272, 256, 1,
                                                torch.float64))


def inputs(p, n0, r, k, dtype, gen):
    """(Linv, U, Sig, b) of one shape."""
    o = dict(generator=gen, device="cuda", dtype=dtype)
    a = torch.randn((p, n0, n0), **o)
    spd = a @ a.mT / n0 + torch.eye(n0, device="cuda", dtype=dtype)
    linv = torch.linalg.inv(torch.linalg.cholesky(spd)).tril().contiguous()
    return (linv, torch.randn((p, n0, r), **o) / 16,
            torch.randn((p // 2, r, r), **o) / r, torch.randn((p, n0, k), **o))


def staged(args, stage_l, stage_u):
    """B4 launched with the given staging (None where its block does not
    fit): returns a function giving (x, c)."""
    linv, u, sig, b = args
    p, n0, k = b.shape
    r = u.shape[2]
    if ops.solve_smem(n0, r, k, b.element_size(), stage_l=stage_l,
                      stage_u=stage_u) > _build.SMEM_MAX:
        return None
    plan = ops.solve_plan(n0, r, k, b.element_size(), linv.data_ptr(),
                          u.data_ptr(), sig.data_ptr())
    x, c = torch.empty_like(b), b.new_empty((p, r, k))

    def run():
        _build.launch("leaf_solve", f"leaf_solve_{_build.SUFFIX[b.dtype]}",
                      b.device, linv, u, sig, b, x, c, p, n0, r, k, 1,
                      int(stage_l), int(stage_u), plan["lw"], plan["uw"],
                      plan["sw"], plan["ldu"], plan["lsize"])
        return x, c
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("leaf_solve_staging: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for p, n0, r, k, dtype in SHAPES:
        args = inputs(p, n0, r, k, dtype, gen)
        want = ref.hck_leaf_solve_ref(*args)
        plan = ops.solve_plan(n0, r, k, args[3].element_size())
        times = {}
        for stage_l in (True, False):
            for stage_u in (True, False):
                run = staged(args, stage_l, stage_u)
                if run is None:
                    continue
                got = run()
                torch.cuda.synchronize()
                err = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(got, want))
                times[f"L {stage_l}, U {stage_u}"] = {
                    "ms": cs.device_ms(run, 10), "rel_err": err}
        print(json.dumps({
            "shape": f"P {p}, n0 {n0}, r {r}, k {k}, {dtype}",
            "plan": f"L {plan['stage_l']}, U {plan['stage_u']}",
            "staging": times,
            "plain_ms": cs.time_ms(lambda: ref.hck_leaf_solve_ref(*args),
                                   5)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
