"""Time the streamed leaf kernels, B5 ``leaf_matvec`` and B13
``leaf_update``, of the checkout this file lives in, on one card.

Builds both libraries from the checkout's sources, holds each kernel
against its plain version (``chip_smoke.py``'s gates: its small shapes in
float32 and float64, and the shapes below), then times each by device time
(``chip_smoke.device_ms``) at the covtype paths' shapes in float32: B5 at
P 4,096, n0 = r = 128 and k 1 (a Lanczos step), 7 (the fit) and 12 (the
sweep's KPCA block); B13 at both update rounds' launches (n0 128 + k 14,
n0 142 + k 12).  Prints one JSON line of the times, bounds and library
times.  To compare two designs, run it from both checkouts in turns (a,
b, b, a) in one session on the card:

    python3 tools/time_streamed_leaves.py
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


def bordered(p, n0, k, gen):
    """(lo, linv, B, C) of p SPD leaves of n0 + k, as an update round
    borders them."""
    o = dict(dtype=torch.float64, device=gen.device)
    a = torch.randn((p, n0 + k, n0 + k), generator=gen, **o)
    full = a @ a.mT / (n0 + k) + torch.eye(n0 + k, **o)
    lo = torch.linalg.cholesky(full[:, :n0, :n0])
    linv = torch.linalg.inv(lo).tril()
    return tuple(t.float().contiguous() for t in (
        lo, linv, full[:, n0:, :n0], full[:, n0:, n0:]))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    logs = _build.build(("leaf_matvec", "leaf_update"))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                cs.say(f"[build] {name}: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 41)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        def rnd(*shape, dtype=dtype):
            return torch.randn(shape, generator=gen, dtype=dtype, device=dev)
        cs.check_matvec_shapes(rtol, rnd)
        cs.check_update_shapes(dtype, rtol, gen, dev)
    p, n0 = 4096, 128
    adiag = cs.factor_leaves(p, n0, torch.float32, gen)
    u = torch.randn((p, n0, n0), generator=gen, device=dev) / math.sqrt(n0)
    out = {"card": torch.cuda.get_device_name(0)}
    for k in (1, 7, 12):
        b = torch.randn((p, n0, k), generator=gen, device=dev)
        rel, _ = cs.check_leaf("matvec", (adiag, u, b), 1e-4)
        out[f"leaf_matvec_k{k}"] = dict(cs.matvec_parts((adiag, u), b),
                                        rel=rel)
    del adiag, u
    for n0, k in ((128, 14), (142, 12)):
        args = bordered(p, n0, k, gen)
        rel_l, rel_i, _ = cs.check_update_kernel(*args, 1e-4)
        out[f"leaf_update_{n0}_{k}"] = dict(cs.update_timing(args),
                                            rel_l=rel_l, rel_i=rel_i)
        del args
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
