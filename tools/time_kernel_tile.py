"""Build B11 ``kernel_tile`` of the checkout this file lives in (with B10
``kernel_matvec`` and B12 ``policy_dist``, which share its code), gate
each of its kernels against the plain version on one card, and time them
in turns at 16,384 x 16,384, d 54 (``chip_smoke.py``'s data).

Prints ptxas's registers and spills of every B11 entry and the count of
C7519 lines (an injected ``warpgroup.arrive``) of each library, then one JSON
line: the largest error of each kernel against the plain version (1e-5
absolute, as ``chip_smoke.py`` gates B11) at 16,384^2, at the ragged 4,097
x 3,001 (d 55: the tensor-core kernel's non-TMA store) and for y is x (the
diagonal against 1); B10's tensor-core route and B12's tiled kernel
against theirs; and the times in ms: the tensor-core kernel ("tc") and the
first design ("pair_tile") for gaussian in turns (tc, pair_tile,
pair_tile, tc), B12's register-tiled form with the epilogue ("tiled") and
"pair_tile" for laplace in turns, each beside its bound; the kernels by
device time (``chip_smoke.device_ms``: calls queued behind a spin kernel,
so the "tc" wrapper's host time is left out)::

    python3 tools/time_kernel_tile.py
"""
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

N = 16384
ATOL = 1e-5


def gap(got, x, y, name, step=4096):
    """max |got - plain| over row chunks of x."""
    from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref

    step = 256 if name == "laplace" else step
    err = 0.0
    for i in range(0, x.shape[0], step):
        want = pairwise_kernel_ref(x[i:i + step], y, name=name,
                                   sigma=cs.SIGMA)
        err = max(err, float((got[i:i + step] - want).abs().max()))
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.kernel_tile import ops
    from repro_torch.kernels.matvec_stage.ops import kernel_matvec
    from repro_torch.kernels.policy_stage import ops as pops

    logs = _build.build(("kernel_tile", "kernel_matvec", "policy_dist"))
    for lib, log in logs.items():
        print(f"[ptxas] {lib}: {sum('C7519' in ln for ln in log.splitlines())}"
              " C7519 lines", flush=True)
        if lib == "kernel_tile":
            for chunk in log.split("Compiling entry function")[1:]:
                print(f"[ptxas] {chunk.split(chr(39))[1]}: " + "; ".join(
                    ln.split(":", 1)[-1].strip() for ln in chunk.splitlines()
                    if "registers" in ln or "spill" in ln), flush=True)
    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x, _, xt, _ = cs.make_data(N, N, dev, gen)
    out = {"card": cs.card(), "checkout": str(ROOT), "errors": {}}
    err = out["errors"]

    def run(kind, a, b, name):
        o = torch.empty((a.shape[0], b.shape[0]), device=dev)
        ops.launch_kernel(kind, a, b, o, name=name, sigma=cs.SIGMA)
        return o

    for name in ("gaussian", "imq", "laplace"):
        kinds = (["tc"] if name != "laplace" else ["tiled"]) + ["pair_tile"]
        for kind in kinds:
            err[f"{name} {kind} 16384^2"] = gap(run(kind, x, xt, name), x, xt,
                                                name)
        a, b = (math.sqrt(2.0 / 55) * torch.randn(s, generator=gen,
                                                  device=dev)
                for s in ((4097, 55), (3001, 55)))
        for kind in kinds:
            err[f"{name} {kind} 4097 x 3001 d 55"] = gap(run(kind, a, b,
                                                             name), a, b,
                                                         name)
        xs = x[:4096]
        kself = ops.pairwise_kernel(xs, xs, name=name, sigma=cs.SIGMA)
        err[f"{name} y is x 4096"] = gap(kself, xs, xs, name)
        err[f"{name} y is x diagonal - 1"] = float(
            (kself.diagonal() - 1).abs().max())
    v = torch.randn((N, cs.N_CLASSES), generator=gen, device=dev)
    z = kernel_matvec(x, xt, v, sigma=cs.SIGMA)
    both = cs.plain_kernel_matvec(x, xt, torch.cat([v, v.abs()], 1),
                                  "gaussian", cs.SIGMA)
    err["B10 tc rel"] = cs.kernel_matvec_gap(z, both)[0]
    blocks = x.view(4, N // 4, cs.D)
    centers = xt[:4 * 128].view(4, 128, cs.D)
    for metric in ("l2", "l1"):
        o1 = torch.empty((4, N // 4, 128), device=dev)
        o2 = torch.empty_like(o1)
        pops.launch_kernel("tiled", blocks, centers, o1, metric=metric)
        pops.launch_kernel("pair_tile", blocks, centers, o2, metric=metric)
        err[f"B12 {metric} tiled == pair_tile"] = bool(torch.equal(o1, o2))
    torch.cuda.synchronize()
    bad = [k for k, e in err.items()
           if (e is False) or (not isinstance(e, bool) and not (
               e <= (2e-6 if k.startswith("B10") else ATOL)))]

    o = torch.empty((N, N), device=dev)
    times = {}
    for name, new in (("gaussian", "tc"), ("laplace", "tiled")):
        fn = {k: (lambda k=k: ops.launch_kernel(k, x, xt, o, name=name,
                                                sigma=cs.SIGMA))
              for k in (new, "pair_tile")}
        t = [cs.device_ms(fn[k], 10) for k in (new, "pair_tile",
                                                "pair_tile", new)]
        times[name] = {"turns": t, new: (t[0] + t[3]) / 2,
                       "pair_tile": (t[1] + t[2]) / 2}
    times["gaussian"]["cdist chain"] = cs.time_ms(
        lambda: torch.exp(torch.cdist(x, xt).square_().mul_(-0.5)), 10)
    out["times_ms"] = times
    out["bound_ms"] = {"bytes": cs.tile_cost(N, N, cs.D)[0] / cs.PEAK_BYTES
                       * 1e3}
    out["failed"] = bad
    print(json.dumps(out), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
