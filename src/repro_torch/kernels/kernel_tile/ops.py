"""Wrapper of the ``kernel_tile`` CUDA kernels (B11, ``csrc/kernel_tile.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.kernel_tile.ref.pairwise_kernel_ref`); on CUDA
tensors it launches one of the library's kernels or raises, at every
shape (the reference's fallback to its jnp oracle below 128 rows is not
carried over).  :func:`route` chooses before the launch: "tc" (float32
gaussian and imq with d <= 64: split TF32 on the tensor cores, fed by B10's
staging :func:`repro_torch.kernels.matvec_stage.ops.prepare_pairs`, the
tile stored by TMA where m % 4 == 0) or "cuda_core" (laplace, and rows
wider than 64: direct sums, by :func:`core_kernel`'s "tiled" kernel for
laplace with d <= 64, else "pair_tile").  ``pairwise_kernel.launches``
counts every launch, ``pairwise_kernel.tc_launches`` those of the
tensor-core kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref
from repro_torch.kernels.matvec_stage.ops import (TC_BM, TC_BN, TC_COLS,
                                                  TC_KERNELS, TC_MAX_D,
                                                  prepare_pairs)

#: rows of X (and of Y) per block tile of the "pair_tile" kernel
BM = BN = 64
#: the most row tiles of X one "pair_tile" launch takes (the grid's y extent)
MAX_ROW_TILES = 65535
#: the widest rows the "tiled" kernel holds (csrc/dist_tiled.cuh DMAX)
TILED_MAX_D = 64
#: the tensor-core kernel's deepest ring of Y tiles, and the bytes of one
#: consumer warpgroup's output staging (64 rows x 64 columns of float32:
#: half its tile)
TC_MAX_STAGES = 4
TC_OUT_STAGING = 64 * (TC_BN // 2) * 4
#: the most chunks of Y one tensor-core launch splits over (grid y)
MAX_CHUNKS = 65535


def route(dtype: torch.dtype, name: str, d: int) -> str:
    """The kernel family that takes ``name`` on inputs of ``dtype`` and
    width ``d``: "tc" (split TF32 on the tensor cores) for float32 gaussian
    and imq with d <= TC_MAX_D, else "cuda_core" (laplace has no
    dot-product identity; a wider X tile would not stay resident).  The
    wrapper casts to float32 first, so it passes float32."""
    if dtype == torch.float32 and name in TC_KERNELS and d <= TC_MAX_D:
        return "tc"
    return "cuda_core"


def core_kernel(d: int) -> str:
    """The CUDA-core kernel for rows of d features: "tiled" (B12's
    register-tiled direct sums, csrc/dist_tiled.cuh; laplace, the one base
    kernel that takes the CUDA cores at this width) up to
    :data:`TILED_MAX_D`, else "pair_tile" (64 x 64 tiles, features staged
    32 at a time)."""
    return "tiled" if d <= TILED_MAX_D else "pair_tile"


def tc_smem(dp: int, stages: int) -> int:
    """Shared memory of one tensor-core block (the kernel's ``tc::Smem``
    plus 1,024 bytes of alignment): X's tile of 128 rows (hi and lo, one
    128-byte box per 32 columns), per stage Y's tile of 128 rows (the same)
    and its 128 norms, the two consumer warpgroups' output staging from a
    1,024-byte boundary, then 8 bytes per mbarrier."""
    nb = -(-dp // TC_COLS)
    y0 = 2 * nb * TC_BM * 128
    yn = y0 + stages * 2 * nb * TC_BN * 128
    out = -(-(yn + stages * TC_BN * 4) // 1024) * 1024
    return 1024 + out + 2 * TC_OUT_STAGING + 8 * (1 + 2 * stages)


def tc_stages(dp: int) -> int:
    """The deepest ring (at most TC_MAX_STAGES) whose block fits in
    :data:`_build.SMEM_MAX`: 2 for dp > 32 (two boxes a row), 4 below."""
    for stages in range(TC_MAX_STAGES, 0, -1):
        if tc_smem(dp, stages) <= _build.SMEM_MAX:
            return stages
    raise ValueError(f"pairwise_kernel: no ring fits {dp} features")


def tc_chunks(n: int, m: int, sms: int) -> int:
    """How many ranges of Y's 128-row tiles the tensor-core grid splits
    into (its y extent): 1 where the blocks of 128 rows of X fill the
    ``sms`` SMs, else as many as keep every SM busy with one block, at most
    one a tile."""
    blocks = -(-n // TC_BM)
    tiles = -(-m // TC_BN)
    return max(1, min(tiles, sms // blocks, MAX_CHUNKS))


def tc_plan(n: int, m: int, d: int, sms: int) -> dict:
    """The tensor-core launch's arguments besides the tensors: dp (d padded
    to a multiple of 8), the ring's stages, the chunks of Y and whether the
    tile is stored by TMA (m % 4 == 0: 16-byte rows) or, otherwise, by
    the threads."""
    dp = -(-d // 8) * 8
    return {"dp": dp, "stages": tc_stages(dp), "chunks": tc_chunks(n, m, sms),
            "tma_out": int(m % 4 == 0)}


def pairwise_kernel(x: torch.Tensor, y: torch.Tensor, *,
                    name: str = "gaussian", sigma: float = 1.0
                    ) -> torch.Tensor:
    """K(X, Y): (n, d), (m, d) -> (n, m) float32 (inputs are cast to
    float32 first, as the reference pins).  When y is x, the tensor-core
    route stages its planes and norms once."""
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_kernel needs x (n, d) and y (m, d); got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    same = y is x
    x = x.to(torch.float32).contiguous()
    y = x if same else y.to(torch.float32).contiguous()
    dev = _build.cuda_device("pairwise_kernel", x, y)
    if dev is None:
        return pairwise_kernel_ref(x, y, name=name, sigma=sigma)
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    kind = route(x.dtype, name, d)
    launch_kernel(kind if kind == "tc" else core_kernel(d), x, y, out,
                  name=name, sigma=sigma)
    return out


def launch_kernel(kind: str, x: torch.Tensor, y: torch.Tensor,
                  out: torch.Tensor, *, name: str, sigma: float) -> None:
    """Launch kernel ``kind`` ("tc", "tiled" or "pair_tile") on float32
    CUDA tensors that :func:`pairwise_kernel` has checked, writing out (n,
    m); counts the launch.  "tiled" takes laplace only, the one base kernel
    its route sends it.  The wrapper's path; called directly only to time
    one kernel against another on the same inputs."""
    n, d = x.shape
    m = y.shape[0]
    dev = out.device
    ep = _build.EPILOGUE_KIND[name]
    if kind == "tc":
        st = prepare_pairs(x, y)
        plan = tc_plan(n, m, d, _sms(dev))
        _build.launch("kernel_tile", "kernel_tile_tc_f32", dev, st["xs"],
                      st["ys"], st["xn"], st["yn"], out, n, m, plan["dp"],
                      ep, float(sigma), plan["stages"], plan["chunks"],
                      plan["tma_out"])
        pairwise_kernel.tc_launches += 1
    elif kind == "tiled":
        if name != "laplace":
            raise ValueError(f"the tiled kernel takes laplace only, not "
                             f"{name!r} (its d <= {TILED_MAX_D} route is "
                             f"tc)")
        _build.launch("kernel_tile", "kernel_tile_tiled_f32", dev, x, y, out,
                      n, m, d, ep, float(sigma))
    elif kind == "pair_tile":
        if -(-n // BM) > MAX_ROW_TILES:
            raise ValueError(f"pairwise_kernel: n={n} rows exceed the "
                             f"{MAX_ROW_TILES * BM} one launch covers")
        _build.launch("kernel_tile", "kernel_tile_f32", dev, x, y, out, n, m,
                      d, ep, float(sigma))
    else:
        raise ValueError(f"unknown kernel {kind!r}; have tc, tiled, "
                         "pair_tile")
    pairwise_kernel.launches += 1


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    """Streaming multiprocessors of ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


pairwise_kernel.launches = 0
pairwise_kernel.tc_launches = 0
