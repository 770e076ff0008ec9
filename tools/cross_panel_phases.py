#!/usr/bin/env python3
"""Where B9's panel form (csrc/build_dist_panel.cu, csrc/cross_panel.cuh)
spends its time at rank 256: the launch built four ways from copies of
csrc/ -- whole, with the Y = K Linv^T phase left out, with the U = Y Linv
panels left out, and with both left out (the distance tile's copy and
epilogue alone) -- each timed by CUDA events at U's level of the rank-256
covtype sweep (1,024 nodes of 512 x 256, float32, gaussian).  The left-out
builds compute nothing useful; they only split the time.

Run on a machine with an H100 and the CUDA toolkit, from the root of a
checkout: ``python3 tools/cross_panel_phases.py`` (~40 s, the four builds
in parallel into build/cross_panel_phases/, which .gitignore lists).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.build_stage import ops as bops  # noqa: E402

OUT = ROOT / "build" / "cross_panel_phases"
NODES, M, R, REPS = 1024, 512, 256, 5
# the edits of csrc/cross_panel.cuh that leave a phase out
NO_Y = ("  for (int i = 0; i < NPAIR; ++i) {\n    const int jp",
        "  for (int i = 0; i < 0; ++i) {\n    const int jp")
NO_U = (("  u_panel<PT>(kr, ring, L", "  if (0) u_panel<PT>(kr, ring, L"),
        ("  u_panel<NT1>(kr, ring, L", "  if (0) u_panel<NT1>(kr, ring, L"))
VARIANTS = {"whole": (), "without Y": (NO_Y,), "without U": NO_U,
            "without Y and U": (NO_Y, *NO_U)}


def build() -> dict:
    """Each variant's library (the copies compiled in parallel)."""
    procs = {}
    for name, edits in VARIANTS.items():
        src = OUT / name.replace(" ", "_")
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        header = src / "cross_panel.cuh"
        text = header.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: csrc/cross_panel.cuh no longer "
                                   f"holds {old!r}")
            text = text.replace(old, new)
        header.write_text(text)
        lib = src / "build_dist_panel.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
               str(lib), str(src / "build_dist_panel.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("cross_panel_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    libs = build()
    gen = torch.Generator(device=dev).manual_seed(0)
    dist = torch.rand((NODES, M, R), generator=gen, device=dev) * 2
    a = torch.randn((NODES, R, R), generator=gen, device=dev) / R
    linv = (torch.eye(R, device=dev) + torch.tril(a)).contiguous()
    u = torch.empty_like(dist)
    table = bops.level_table("cross_panel_phases",
                             [(dist, linv, u, NODES, M)])
    stream = torch.cuda.current_stream().cuda_stream
    print(f"{smi}; B9's panel form at {NODES} nodes of {M} x {R} (f32, "
          f"gaussian), {REPS} launches a reading:")
    for name, lib in libs.items():
        fn = lib.cross_solve_dist_levels_panel_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call():
            code = fn(table.data_ptr(), 1, R, 0, 1.0, stream)
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")

        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call()
        end.record()
        torch.cuda.synchronize()
        print(f"  {name}: {start.elapsed_time(end) / REPS:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
