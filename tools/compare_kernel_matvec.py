"""Time B10's tensor-core kernel (``kernel_matvec_tc_f32``) of two
checkouts in turns on one card: this file's checkout and the one named on
the command line (an unpacked parent, say), each library built with
``nvcc`` from its own ``src/repro_torch/csrc``, both called through ctypes
on the same staged inputs (n 131,072, d 54, k 7, gaussian, this
checkout's ``prepare_tc``; the two must take the same arguments).  Checks
that the outputs are equal bit for bit and prints one JSON line: the
times in ms of rounds of (other, this, this, other) and their medians::

    python3 tools/compare_kernel_matvec.py path/to/other/checkout
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.matvec_stage import ops as mv  # noqa: E402

N, K, ROUNDS = 131072, 7, 5


def build(tag: str, csrc: Path, out: Path):
    """The library's ``kernel_matvec_tc_f32``, built from ``csrc``."""
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / "kernel_matvec.cu")],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(out)).kernel_matvec_tc_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    other = Path(sys.argv[1]).resolve()
    work = ROOT / "build" / "compare_kernel_matvec"
    work.mkdir(parents=True, exist_ok=True)
    libs = {tag: build(tag, root / "src" / "repro_torch" / "csrc",
                       work / f"{tag}.so")
            for tag, root in (("other", other), ("this", ROOT))}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = cs.make_data(N, 8, dev, gen)[0]
    v = torch.randn((N, K), generator=gen, device=dev)
    st = mv.prepare_tc(x, x, v)
    outs = {tag: torch.empty((N, K), device=dev) for tag in libs}

    def call(tag):
        def run():
            code = libs[tag](
                st["xs"].data_ptr(), st["ys"].data_ptr(), st["vt"].data_ptr(),
                st["xn"].data_ptr(), st["yn"].data_ptr(),
                outs[tag].data_ptr(), N, N, st["dp"], st["kp"], st["mp"], 0,
                K, 8, K, _build.EPILOGUE_KIND["gaussian"], cs.SIGMA,
                mv.tc_stages(st["dp"], 8),
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"{tag}: CUDA error {code}")
        return run

    for tag in libs:
        call(tag)()
    torch.cuda.synchronize()
    times = {tag: [] for tag in libs}
    for _ in range(ROUNDS):
        for tag in ("other", "this", "this", "other"):
            times[tag].append(cs.time_ms(call(tag), 3, warmup=1))
    print(json.dumps({
        "card": cs.card(), "other": str(other),
        "equal": bool(torch.equal(outs["other"], outs["this"])),
        "median_ms": {t: statistics.median(v) for t, v in times.items()},
        "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
