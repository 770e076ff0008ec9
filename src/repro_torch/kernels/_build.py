"""Build, load and launch the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which is loaded with
``ctypes``.  The build happens at first use, into ``build/repro_torch/``
at the root of the checkout; the library name carries a digest of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  :func:`build` starts one ``nvcc`` per missing library, all
together, and waits for all of them.  :func:`cuda_device`,
:func:`check_smem` and :func:`launch` are the checks and the ctypes call
every kernel wrapper shares.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("hck_leaf_project", "oos_contract", "build_stage", "build_dist",
           "leaf_factor", "leaf_matvec", "leaf_solve", "kernel_matvec",
           "kernel_tile", "policy_dist", "leaf_update", "flash_attention",
           "ssd_chunk", "build_stage_bf16", "build_dist_bf16",
           "oos_contract_bf16", "leaf_factor_panel", "build_stage_panel",
           "build_dist_panel", "build_stage_panel_bf16",
           "build_dist_panel_bf16", "leaf_update_panel")
#: the libraries compiled from other libraries' sources: the bfloat16-data
#: entries (each ``<base>_bf16.cu`` the base source compiled for those
#: entries alone), the panel forms (each ``<base>_panel.cu`` the base
#: source compiled without its own entries, then the panel kernels) and
#: the panel forms' bfloat16-data entries (``<base>_panel_bf16.cu``)
BASE = {"build_stage_bf16": ("build_stage.cu",),
        "build_dist_bf16": ("build_dist.cu",),
        "oos_contract_bf16": ("oos_contract.cu",),
        "leaf_factor_panel": ("leaf_factor.cu",),
        "build_stage_panel": ("build_stage.cu",),
        "build_dist_panel": ("build_dist.cu",),
        "build_stage_panel_bf16": ("build_stage_panel.cu", "build_stage.cu"),
        "build_dist_panel_bf16": ("build_dist_panel.cu", "build_dist.cu")}
_HEADERS = ("kernel_epilogue.cuh", "cross_products.cuh", "pair_tile.cuh",
            "hopper.cuh", "tf32x3.cuh", "async_copy.cuh", "chol_blocked.cuh",
            "cross_tc.cuh", "level_groups.cuh", "leaf_stream.cuh",
            "data_load.cuh", "tc_pairs.cuh", "dist_tiled.cuh",
            "chol_panel.cuh", "cross_panel.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: shared memory one block can have on the H100 (227 KB, opt-in above 48 KB)
SMEM_MAX = 227 * 1024
#: base-kernel kinds of csrc/kernel_epilogue.cuh
EPILOGUE_KIND = {"gaussian": 0, "imq": 1, "laplace": 2}
#: symbol suffix of each dtype a kernel library exports
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
#: the dtypes a kernel takes unless its wrapper names others
#: (``flash_attention`` takes bfloat16 throughout; the bfloat16-data entries
#: of B1, B2, B7, B8 and B9, resident and panel forms, take it in their data
#: group, see :func:`cuda_device`)
FLOAT_DTYPES = (torch.float32, torch.float64)

_LOADED: dict[str, ctypes.CDLL] = {}
_SYMBOLS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Path of the shared library of kernel ``name`` for the current sources."""
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {KERNELS}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu",) + BASE.get(name, ()) + _HEADERS:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` that is missing, in parallel.

    Returns the compiler's output per kernel (``-Xptxas -v`` reports
    registers and shared memory); an empty string means the library was
    already built.  Raises ``RuntimeError`` if any compilation fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def library(base: str, data: torch.Tensor) -> str:
    """The library of kernel library ``base`` for ``data``: its
    ``<base>_bf16`` library for bfloat16 data, else ``base``."""
    return f"{base}_bf16" if data.dtype == torch.bfloat16 else base


def check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError() != 0``)."""
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} "
                           f"({msg})")


def cuda_device(stage: str, *tensors: torch.Tensor,
                dtypes: tuple = FLOAT_DTYPES,
                data: tuple = ()) -> torch.device | None:
    """The CUDA device a kernel of ``stage`` launches on, or None when every
    tensor lies on the CPU (the wrapper then runs the plain version).

    Raises unless the tensors share one CUDA device, one dtype of
    ``dtypes`` (float32 or float64 unless the kernel names others) and are
    contiguous.  ``data`` is the kernel's data group where it has a
    bfloat16-data entry (points, landmarks, queries or cached distance
    tiles; ``tensors`` are then its factors): the data share one dtype,
    the factors' one or, beside float32 factors or alone, bfloat16 (the
    data of a mixed-precision policy).  The kernels have no backward
    pass, so a tensor that needs a gradient (with grad mode on) raises
    too, rather than give a gradient that leaves the kernel out.
    """
    every = tensors + tuple(data)
    if all(t.device.type == "cpu" for t in every):
        return None
    if torch.is_grad_enabled() and any(t.requires_grad for t in every):
        raise RuntimeError(
            f"{stage}: the CUDA kernel has no backward pass; its inputs must "
            "not require grad (differentiate through the plain versions on "
            "CPU tensors)")
    dev = every[0].device
    if dev.type != "cuda" or any(t.device != dev for t in every):
        raise ValueError(f"{stage} needs all tensors on one CUDA device; got "
                         f"{[str(t.device) for t in every]}")
    names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
    if tensors and (tensors[0].dtype not in dtypes or any(
            t.dtype != tensors[0].dtype for t in tensors)):
        raise TypeError(f"{stage} kernel takes {names} of one dtype; got "
                        f"{[t.dtype for t in tensors]}")
    if data:
        fac = tensors[0].dtype if tensors else None
        allowed = ({fac} if fac is not None else set(dtypes))
        if fac in (None, torch.float32):
            allowed.add(torch.bfloat16)
        if data[0].dtype not in allowed or any(
                t.dtype != data[0].dtype for t in data):
            raise TypeError(
                f"{stage} kernel takes data of one dtype, that of its "
                f"factors or bfloat16 beside float32 factors; got data "
                f"{[t.dtype for t in data]}, factors "
                f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in every):
        raise ValueError(f"{stage} kernel needs contiguous tensors")
    return dev


def check_smem(stage: str, nbytes: int, what: str) -> None:
    """Raise ``ValueError`` when a block would need more than
    :data:`SMEM_MAX` bytes of shared memory."""
    if nbytes > SMEM_MAX:
        raise ValueError(
            f"{stage}: {what} needs {nbytes} bytes of shared memory per "
            f"block, above the {SMEM_MAX} a block can have")


def _ctype(a):
    """The ctypes type a launch argument is passed as."""
    if isinstance(a, ctypes.c_longlong):
        return ctypes.c_longlong
    if a is None or isinstance(a, torch.Tensor):
        return ctypes.c_void_p
    return ctypes.c_double if isinstance(a, float) else ctypes.c_int


def _symbol(name: str, symbol: str, args: tuple):
    """``symbol`` of library ``name``, its argument types set from ``args``
    (plus the trailing stream) at first use."""
    fn = _SYMBOLS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = [_ctype(a) for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _SYMBOLS[(name, symbol)] = fn
    return fn


def launch(name: str, symbol: str, dev: torch.device, *args) -> None:
    """Call ``symbol`` of library ``name`` with ``args`` (tensors become
    their data pointers, None a null pointer, floats doubles, ints ints,
    ``ctypes.c_longlong`` values long longs) on the current stream of
    ``dev``; raise if the launch failed.  A symbol keeps the argument types
    of its first call."""
    fn = _symbol(name, symbol, args)
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*values, stream)
    check_launch(_LOADED[name], symbol, code)
