"""Wrapper of the ``kernel_matvec`` CUDA kernels (B10,
``csrc/kernel_matvec.cu``).

On CPU tensors the wrapper computes the plain version
(:func:`repro_torch.kernels.matvec_stage.ref.kernel_matvec_ref`); on CUDA
tensors it launches one of the library's two kernels or raises, chosen by
:func:`route` before the launch: "tc" (float32 gaussian and imq: split
TF32 on the tensor cores, fed by :func:`prepare_tc`) or "cuda_core"
(laplace and float64: every sum in the inputs' dtype on the CUDA cores).
Neither kernel materialises the (b, m) tile, so, unlike the plain version,
one launch covers every row of Xc.  ``kernel_matvec.launches`` counts
every launch, ``kernel_matvec.tc_launches`` those of the tensor-core
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import KERNEL_METRIC
from repro_torch.kernels import _build
from repro_torch.kernels.matvec_stage.ref import kernel_matvec_ref

#: tile shape of the CUDA-core kernel (csrc/kernel_matvec.cu with
#: pair_tile.cuh): rows of Xc and of Y per block tile, features per staged
#: chunk, V columns per pass
BM = BN = 64
DC = 32
KC = 32

#: base kernels the tensor-core kernel takes: those of the squared
#: distance, which the norm identity turns into a dot product
TC_KERNELS = ("gaussian", "imq")
#: the widest rows the tensor-core kernel keeps resident: Xc's tile holds
#: two 128-byte boxes (32 float32 columns each) of hi and of lo per row
TC_MAX_D = 64
#: tile shape of the tensor-core kernel: rows of Xc per block, rows of Y per
#: tile, columns per TMA box, the deepest ring
TC_BM = TC_BN = 128
TC_COLS = 32
TC_MAX_STAGES = 4
#: widest column group one tensor-core launch takes (its wgmma N)
TC_MAX_KP = 32
#: the real row of V that the logical row p of each group of 8 stands for:
#: the accumulator's thread holds columns 2t, 2t + 1 where the A fragment
#: wants t, t + 4 (csrc/tf32x3.cuh)
KEY_OF = (0, 2, 4, 6, 1, 3, 5, 7)


def matvec_smem(kc: int, itemsize: int) -> int:
    """Shared memory of one CUDA-core block for ``kc`` columns: the two
    staged feature chunks (DC x (BM + 1) and DC x (BN + 1)), the (BM, BN +
    1) kernel tile, a (BN, KC + 1) chunk of V and the (BM, kc)
    accumulators."""
    return (DC * (BM + 1 + BN + 1) + BM * (BN + 1) + BN * (KC + 1)
            + BM * kc) * itemsize


def max_columns(itemsize: int) -> int:
    """The most right-hand-side columns one CUDA-core launch keeps on the
    chip."""
    return (_build.SMEM_MAX // itemsize - DC * (BM + BN + 2)
            - BM * (BN + 1) - BN * (KC + 1)) // BM


def route(dtype: torch.dtype, name: str, d: int) -> str:
    """The kernel that takes ``name`` on inputs of ``dtype`` and width
    ``d``: "tc" (split TF32 on the tensor cores) for float32 gaussian and
    imq with d <= TC_MAX_D, else "cuda_core" (laplace has no dot-product
    identity; float64 keeps every sum in float64; wider rows do not fit the
    tensor-core kernel's resident tile)."""
    if dtype == torch.float32 and name in TC_KERNELS and d <= TC_MAX_D:
        return "tc"
    return "cuda_core"


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def tf32_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 a -> (hi, lo): hi = tf32(a), lo = tf32(a - hi), each rounded
    to 10 mantissa bits, to nearest with ties away from zero (PTX
    ``cvt.rna.tf32.f32``: the half-unit added to the magnitude bits, the low
    13 bits cleared).  a - hi is exact, so hi + lo = a within 2^-22 |a|."""
    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a)
    return hi, rna(a - hi)


def permute_keys(v: torch.Tensor) -> torch.Tensor:
    """(m, k) with m % 8 == 0 -> the rows of each group of 8 in the order
    KEY_OF: row 8 j + p of the result is row 8 j + KEY_OF[p] of v."""
    m, k = v.shape
    return v.reshape(m // 8, 8, k)[:, list(KEY_OF), :].reshape(m, k)


def prepare_pairs(x: torch.Tensor, y: torch.Tensor) -> dict:
    """The inputs of the tensor-core front half that B10 and B11 share
    (``csrc/tc_pairs.cuh``), staged once per call in float32:

    * ``xs`` (2, b, dp) and ``ys`` (2, m, dp): the hi and lo planes of X
      and Y (:func:`tf32_split`), d padded with zeros to dp, a multiple of 8
      (16-byte rows for TMA, whole k-steps of 8);
    * ``xn`` (b,) and ``yn`` (m padded to a multiple of TC_BN, zeros past
      m): squared norms, taken from the unsplit rows.

    When y is x, its planes and norms are staged once.
    """
    b, d = x.shape
    m = y.shape[0]
    dp = _round_up(d, 8)

    def planes(a):
        padded = torch.nn.functional.pad(a, (0, dp - d))
        return torch.stack(tf32_split(padded)).contiguous()

    xs = planes(x)
    xn = (x * x).sum(dim=1)
    ys = xs if y is x else planes(y)
    yn = torch.zeros(_round_up(m, TC_BN), dtype=torch.float32,
                     device=y.device)
    yn[:m] = xn if y is x else (y * y).sum(dim=1)
    return {"xs": xs, "ys": ys, "xn": xn, "yn": yn, "dp": dp}


def prepare_tc(xc: torch.Tensor, y: torch.Tensor, v: torch.Tensor) -> dict:
    """The tensor-core kernel's inputs, staged once per call in float32:
    :func:`prepare_pairs`' planes and norms of Xc and Y, and

    * ``vt`` (2, kp, mp): V^T split into hi and lo, k padded to kp and m to
      mp (multiples of 8, zeros), its columns (V's rows) permuted within
      each group of 8 by :func:`permute_keys`.
    """
    m, k = v.shape
    kp, mp = _round_up(k, 8), _round_up(m, 8)
    st = prepare_pairs(xc, y)
    vp = torch.zeros((mp, kp), dtype=torch.float32, device=v.device)
    vp[:m, :k] = v
    vt = torch.stack(tf32_split(permute_keys(vp).T.contiguous()))
    return {**st, "vt": vt.contiguous(), "kp": kp, "mp": mp}


def tc_groups(k: int) -> list[tuple[int, int, int]]:
    """(first column, columns, wgmma N) of each tensor-core launch for k
    columns: groups of up to TC_MAX_KP, each computing S once; N is 8, 16
    or 32, the group's width rounded up."""
    out = []
    for c0 in range(0, k, TC_MAX_KP):
        kc = min(TC_MAX_KP, k - c0)
        out.append((c0, kc, 8 if kc <= 8 else 16 if kc <= 16 else 32))
    return out


def tc_smem(dp: int, kp: int, stages: int) -> int:
    """Shared memory of one tensor-core block (the kernel's ``tc::Smem``
    plus 1,024 bytes of alignment): Xc's tile of 128 rows (hi and lo, one
    128-byte box per 32 columns), and per stage Y's tile of 128 rows (the
    same), V^T's 128 keys (hi and lo, kp rows of 128 bytes per 32 keys) and
    128 norms; then 8 bytes per mbarrier."""
    nb = -(-dp // TC_COLS)
    per_stage = (2 * nb * TC_BN * 128 + 2 * (TC_BN // TC_COLS) * kp * 128
                 + TC_BN * 4)
    return (1024 + 2 * nb * TC_BM * 128 + stages * per_stage
            + 8 * (1 + 2 * stages))


def tc_stages(dp: int, kp: int) -> int:
    """The deepest ring (at most TC_MAX_STAGES) whose block fits in
    :data:`_build.SMEM_MAX`."""
    for stages in range(TC_MAX_STAGES, 0, -1):
        if tc_smem(dp, kp, stages) <= _build.SMEM_MAX:
            return stages
    raise ValueError(f"kernel_matvec: no ring fits {dp} features and {kp} "
                     "columns")


def kernel_matvec(
    xc: torch.Tensor, y: torch.Tensor, v: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0,
) -> torch.Tensor:
    """z = K(Xc, Y) V: (b, d), (m, d), (m, k) -> (b, k), in the dtype of
    the inputs (float32 or float64, all one dtype on the card).

    The kernel is :func:`route`'s.  On the tensor cores each column group
    of :func:`tc_groups` is one launch that computes S once for all of its
    columns; on the CUDA cores each group of up to :func:`max_columns`
    columns (at most 745 in float32 and 291 in float64, above any width
    the solvers use) is one launch that computes the distances once.
    """
    if name not in KERNEL_METRIC:
        raise ValueError(f"unknown base kernel {name!r}; have "
                         f"{sorted(KERNEL_METRIC)}")
    if (xc.ndim != 2 or y.ndim != 2 or v.ndim != 2
            or xc.shape[1] != y.shape[1] or v.shape[0] != y.shape[0]):
        raise ValueError(
            "kernel_matvec needs xc (b, d), y (m, d) and v (m, k); got "
            f"{tuple(xc.shape)}, {tuple(y.shape)}, {tuple(v.shape)}")
    dev = _build.cuda_device("kernel_matvec", xc, y, v)
    if dev is None:
        return kernel_matvec_ref(xc, y, v, name=name, sigma=sigma)
    b, d = xc.shape
    k = v.shape[1]
    z = torch.empty((b, k), dtype=xc.dtype, device=dev)
    if z.numel():
        launch_kernel(route(xc.dtype, name, d), xc, y, v, z, name=name,
                      sigma=sigma)
    return z


def launch_kernel(kind: str, xc: torch.Tensor, y: torch.Tensor,
                  v: torch.Tensor, z: torch.Tensor, *, name: str,
                  sigma: float) -> None:
    """Launch kernel ``kind`` ("tc" or "cuda_core") on CUDA tensors that
    :func:`kernel_matvec` has checked, writing z (b, k); counts each
    launch.  The wrapper's path; called directly only to time one kernel
    against the other on the same inputs."""
    b, d = xc.shape
    m, k = v.shape
    dev = z.device
    if kind == "tc":
        if m == 0:
            z.zero_()
            return
        st = prepare_tc(xc, y, v)
        for c0, kc, kp in tc_groups(k):
            _build.launch("kernel_matvec", "kernel_matvec_tc_f32", dev,
                          st["xs"], st["ys"], st["vt"], st["xn"], st["yn"],
                          z[:, c0:], b, m, st["dp"], st["kp"], st["mp"], c0,
                          kc, kp, k, _build.EPILOGUE_KIND[name],
                          float(sigma), tc_stages(st["dp"], kp))
            kernel_matvec.launches += 1
            kernel_matvec.tc_launches += 1
        return
    sym = f"kernel_matvec_{_build.SUFFIX[xc.dtype]}"
    step = max_columns(xc.element_size())
    for k0 in range(0, k, step):
        kc = min(step, k - k0)
        _build.check_smem("kernel_matvec",
                          matvec_smem(kc, xc.element_size()),
                          f"{kc} right-hand-side columns")
        _build.launch("kernel_matvec", sym, dev, xc, y, v[:, k0:], z[:, k0:],
                      b, m, d, kc, k, _build.EPILOGUE_KIND[name],
                      float(sigma))
        kernel_matvec.launches += 1


kernel_matvec.launches = 0
kernel_matvec.tc_launches = 0
