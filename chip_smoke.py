#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA card and ``nvcc``; without a card it exits with code 1 and prints no
result.  Phases, each of which raises on failure:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every kernel of the fit and serving paths (in
              parallel);
  3. fit      the full-width covtype KRR fit through ``krr.fit`` (synthetic
              data at that width): the kernels' launch counts read around
              exactly this call; then the same fit stage by stage, timed,
              with its solve residual through the port's own matvec;
  4. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the fit and serving paths give it (f32) and at a
              small shape (f64), with the tolerance stated on its line;
  5. exact    an n = 4,096 fit at covtype width in f64 against the dense
              oracle, the f32 fit against the f64 one on the same tree and
              landmarks, and the f32 engine against the f64 Algorithm-3
              oracle;
  6. serve    the fitted full-width model served through ``model.engine``
              (warmup, 16 requests of mixed sizes and one of all 116,203
              test queries), the launch counts read around exactly this
              run, and its test accuracy;
  7. timing   kernel, plain-version and library times at the fit and
              serving shapes, beside each kernel's bound;
  8. profile  torch.profiler over one full-width fit and over five
              4096-query requests: device time by kernel, and the device's
              busy share.

The data is synthetic (seeded), at covtype's size and width, with seven
labels from a seeded nonlinear function of x; its accuracy says nothing of
the real dataset.  Correctness against the JAX reference is held by the
CPU tests (tests/test_torch_*.py).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernels' JSON record.
"""
from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# The covtype row of the reference's dataset table (copied, not imported).
N_TRAIN, N_TEST, D, N_CLASSES = 464_809, 116_203, 54, 7
RANK, LEAF, SIGMA, JITTER, LAM = 128, 128, 1.0, 1e-5, 1e-2
LEVELS = 12                        # 464,809 padded to 128 * 2**12 = 524,288
EXACT_N, EXACT_LEVELS = 4096, 5    # the dense-oracle fit: 32 leaves of 128
SEED = 0

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def say(*parts) -> None:
    """Print one line of the run's record and flush it."""
    print(*parts, flush=True)


def require(cond: bool, what: str) -> None:
    """Fail the run (non-zero exit) unless ``cond``."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    """Wait for the card."""
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Data, launch counters and the float64 copy of a model
# ---------------------------------------------------------------------------

def make_data(n: int, n_test: int, dev, gen: torch.Generator,
              dtype=torch.float32):
    """Synthetic data at covtype width: x ~ N(0, (2/d) I), so that
    E||x - y||^2 = 4 sigma^2 and the gaussian kernel values are O(0.1),
    and seven labels, the argmax of a seeded nonlinear function of x.
    Returns (x, labels, test points, test labels)."""
    opts = dict(dtype=dtype, device=dev)
    g = torch.randn((D, N_CLASSES), generator=gen, **opts)
    scale = math.sqrt(2.0 / D)
    x = scale * torch.randn((n, D), generator=gen, **opts)
    xt = scale * torch.randn((n_test, D), generator=gen, **opts)

    def label(pts):
        t = pts @ g
        return torch.argmax(torch.sin(3.0 * t) + 0.5 * t * t, dim=1)

    return x, label(x), xt, label(xt)


def one_vs_all(labels: torch.Tensor, dtype) -> torch.Tensor:
    """(n,) class labels -> (n, classes) +-1 targets, as the fit codes them."""
    classes = torch.unique(labels)
    one = torch.ones((), dtype=dtype, device=labels.device)
    return torch.where(labels[:, None] == classes[None, :], one, -one)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper (which counts its launches) by kernel name."""
    from repro_torch.kernels.build_stage import ops as build_ops
    from repro_torch.kernels.hck_leaf import ops as leaf_ops
    from repro_torch.kernels.oos_stage import ops as oos_ops

    return {"gram_chol": build_ops.build_gram,
            "cross_solve": build_ops.build_cross,
            "leaf_factor": leaf_ops.leaf_factor,
            "leaf_solve": leaf_ops.leaf_solve,
            "leaf_matvec": leaf_ops.leaf_matvec,
            "hck_leaf_project": leaf_ops.leaf_project,
            "oos_contract": oos_ops.oos_contract}


def plain_versions() -> list:
    """Every kernel's plain version (each counts its calls)."""
    from repro_torch.kernels.build_stage import ref as build_ref
    from repro_torch.kernels.hck_leaf import ref as leaf_ref
    from repro_torch.kernels.oos_stage import ref as oos_ref

    return [build_ref.build_gram_ref, build_ref.build_cross_ref,
            leaf_ref.hck_leaf_factor_ref, leaf_ref.hck_leaf_solve_ref,
            leaf_ref.hck_leaf_matvec_ref, leaf_ref.hck_leaf_project_ref,
            oos_ref.oos_contract_ref]


def reset_counts() -> None:
    """Set every kernel's launch count and plain version's call count to 0."""
    for fn in kernel_wrappers().values():
        fn.launches = 0
    for fn in plain_versions():
        fn.calls = 0


def read_counts() -> tuple[dict, dict]:
    """(launches by kernel, calls by plain version)."""
    return ({name: fn.launches for name, fn in kernel_wrappers().items()},
            {fn.__name__: fn.calls for fn in plain_versions()})


def to_f64(f):
    """A float64 copy of factors ``f`` (for the oracles)."""
    from repro_torch.core.hck import HCKFactors
    from repro_torch.core.partition import PartitionTree

    d = lambda t: t.double()
    tr = f.tree
    return HCKFactors(
        d(f.x_sorted), PartitionTree(tr.perm, tuple(map(d, tr.directions)),
                                     tuple(map(d, tr.thresholds))),
        tuple(map(d, f.landmarks)), tuple(map(d, f.sigma)),
        tuple(map(d, f.sigma_cho)), tuple(map(d, f.w)), d(f.u), d(f.adiag))


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(2):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card, and which rate bounds it."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_flops(entries, points, d):
    """Least flops for ``entries`` gaussian kernel values among ``points``
    distinct points of width d: each point's squared norm once (2d), then
    per entry the dot product (2d), the identity |p|^2 + |z|^2 - 2 p.z (3)
    and the epilogue (1)."""
    return entries * (2 * d + 4) + points * 2 * d


def gram_cost(points, want_chol):
    """gram_chol: points read once, the Gram (and factor) written once;
    the m(m + 1)/2 distinct entries of each symmetric Gram, the jitter on
    its diagonal and m^3 / 3 for the factor."""
    b, m, d = points.shape
    s = points.element_size()
    nbytes = s * (b * m * d + b * m * m * (2 if want_chol else 1))
    flops = kernel_flops(b * m * (m + 1) // 2, b * m, d) + b * m
    return nbytes, flops + (b * m ** 3 / 3 if want_chol else 0)


def cross_cost(points, landmarks, linv):
    """cross_solve: inputs read once, U written once; the m x r kernel
    entries of each node and, per row, two products with the lower
    triangular Linv (r^2 flops each)."""
    b, m, d = points.shape
    r = landmarks.shape[1]
    s = points.element_size()
    nbytes = s * (b * m * d + b * r * d + b * r * r + b * m * r)
    return nbytes, kernel_flops(b * m * r, b * (m + r), d) + 2 * b * m * r * r


def factor_cost(dleaf):
    """leaf_factor: D read, L and L^-1 written; n0^3 / 3 flops for each."""
    p, n0, _ = dleaf.shape
    return 3 * dleaf.element_size() * p * n0 * n0, 2 * p * n0 ** 3 / 3


def matvec_cost(adiag, u, b):
    """leaf_matvec: A, U and b read, y and c written."""
    p, n0, r = u.shape
    k = b.shape[2]
    nbytes = adiag.element_size() * (p * n0 * n0 + p * n0 * r
                                     + 2 * p * n0 * k + p * r * k)
    return nbytes, 2 * p * n0 * k * (n0 + r)


def solve_cost(linv, u, sig, b):
    """leaf_solve: Linv, U, the Sig blocks and b read, x and c written;
    per column two products with the lower triangular Linv (n0^2 flops
    each), U^T b and U (Sig c)."""
    p, n0, r = u.shape
    k = b.shape[2]
    nbytes = linv.element_size() * (p * n0 * n0 + p * n0 * r
                                    + sig.shape[0] * r * r
                                    + 2 * p * n0 * k + p * r * k)
    return nbytes, 2 * p * k * (n0 * n0 + 2 * n0 * r + r * r)


def project_cost(u, b):
    """Bytes and flops of c = U^T b: each input read once, c written once."""
    p, n0, r = u.shape
    k = b.shape[2]
    return 4 * (p * n0 * r + p * n0 * k + p * r * k), 2 * p * n0 * r * k


def contract_cost(points, weights, queries, pidx, widx):
    """Bytes and flops of the indexed contraction for this batch: the
    distinct point and weight blocks it touches, the queries, the indices
    and the output; the kernel values (kernel_flops: norms of the touched
    rows and the queries once) and 2k flops per (query, row) for the
    weighted sums."""
    _, m, d = points.shape
    k = weights.shape[2]
    q = queries.shape[0]
    nbytes = (4 * (pidx.unique().numel() * m * d
                   + widx.unique().numel() * m * k + q * d + q * k)
              + 8 * 2 * q)
    rows = pidx.unique().numel() * m + q
    return nbytes, kernel_flops(q * m, rows, d) + q * m * 2 * k


# ---------------------------------------------------------------------------
# The launch arguments of each kernel on the fit path
# ---------------------------------------------------------------------------

def fit_launches(f, inv, b):
    """The arguments of every kernel launch one fit makes, by kernel:
    gram_chol per level (Sigma) and for the leaves (Adiag), cross_solve
    for U and per level for W, leaf_factor once, leaf_solve and
    leaf_matvec as in one refinement round."""
    from repro_torch.core import hmatrix
    from repro_torch.core.hck import sigma_linv

    n0, d = f.leaf_size, f.x_sorted.shape[1]
    leaves = f.x_sorted.view(f.num_leaves, n0, d)
    linv = [sigma_linv(c) for c in f.sigma_cho]
    cross = [(leaves.reshape(f.num_leaves // 2, 2 * n0, d), f.landmarks[-1],
              linv[-1])]
    for lvl in range(1, f.levels):
        cross.append((f.landmarks[lvl].reshape(1 << (lvl - 1), 2 * f.rank, d),
                      f.landmarks[lvl - 1], linv[lvl - 1]))
    eye = torch.eye(n0, dtype=f.adiag.dtype, device=f.adiag.device)
    return {
        "gram": [(lm, True) for lm in f.landmarks] + [(leaves, False)],
        "cross": [tuple(t.contiguous() for t in args) for args in cross],
        "dleaf": (hmatrix._leaf_schur(f) + LAM * eye).contiguous(),
        "solve": tuple(t.contiguous() for t in (inv.linv, inv.u,
                                                 inv.sigma[-1], b)),
        "matvec": tuple(t.contiguous() for t in (f.adiag, f.u, b)),
    }


# ---------------------------------------------------------------------------
# Kernel-vs-plain comparisons
# ---------------------------------------------------------------------------

def check_rel(name: str, got, want, rtol: float) -> float:
    """Gate max |got - want| <= rtol * max |want| (both finite)."""
    require(bool(torch.isfinite(got).all()), f"{name} output finite")
    rel = rel_max(got, want)
    require(rel <= rtol, f"{name} rel {rel:.3e} <= {rtol}")
    return rel


def check_build(points, want_chol, rtol, name="gaussian", sigma=SIGMA,
                jitter=JITTER):
    """B1 against its plain version.  The kernel sums (p - q)^2 directly,
    the plain version uses the norm identity: in float32 the Gram entries
    differ by ~eps * (|p|^2 + |q|^2) and the factors by that amplified by
    the Cholesky's conditioning; rtol is the documented f32 bound of the
    Gram-family factors, 1e-4 (1e-10 in float64)."""
    from repro_torch.kernels.build_stage.ops import build_gram
    from repro_torch.kernels.build_stage.ref import build_gram_ref

    opts = dict(name=name, sigma=sigma, jitter=jitter, want_chol=want_chol)
    got, want = build_gram(points, **opts), build_gram_ref(points, **opts)
    sync()
    errs = [check_rel(f"gram_chol[{name}] gram", got[0], want[0], rtol)]
    if want_chol:
        errs.append(check_rel(f"gram_chol[{name}] chol", got[1], want[1],
                              rtol))
    return max(errs), float((got[0] - want[0]).abs().max())


def check_cross(args, rtol, name="gaussian"):
    """B2 against its plain version.  U = K Linv^T Linv is amplified by
    kappa(Sigma), large where padding rows put near-duplicate landmarks in
    one node (phase 4 prints it), so, as the reference's registry argues
    for U and W, no relative bound holds entry by entry.  The gate is the componentwise
    bound of the two products, |dU| <= 4 (2r + d) eps |K| |Linv|^T |Linv|:
    2r for the two length-r sums of each side, d for the kernel values,
    whose distances the kernel sums directly and the plain version through
    the norm identity.  In float64 also rel <= rtol (1e-10)."""
    from repro_torch.core.kernels_fn import get_kernel
    from repro_torch.kernels.build_stage.ops import build_cross
    from repro_torch.kernels.build_stage.ref import build_cross_ref

    pts, lm, linv = args
    got = build_cross(*args, name=name, sigma=SIGMA)
    want = build_cross_ref(*args, name=name, sigma=SIGMA)
    sync()
    require(bool(torch.isfinite(got).all()), f"cross_solve[{name}] finite")
    r, d = lm.shape[1], lm.shape[2]
    kabs = get_kernel(name)(pts, lm, sigma=SIGMA).abs()
    bound = (kabs @ linv.abs().mT) @ linv.abs()
    eps = torch.finfo(pts.dtype).eps
    err = (got - want).abs()
    require(bool((err <= 4 * (2 * r + d) * eps * bound).all()),
            f"cross_solve[{name}] |dU| <= 4 (2r + d) eps |K||Linv^T||Linv|")
    rel = rel_max(got, want)
    if pts.dtype == torch.float64:
        require(rel <= rtol, f"cross_solve[{name}] rel {rel:.3e} <= {rtol}")
    return rel, float(err.max())


def check_factor(dleaf, rtol):
    """B3 against its plain version: L within rtol relative (1e-4 in
    float32, the Gram-family factor bound; 1e-10 in float64); L^-1, which
    is amplified by kappa(L), through the inverse check below, its
    relative difference printed.  Two backward-error checks with the
    standard componentwise bounds (Higham, Accuracy and Stability, Thms
    10.3 and 8.10), doubled: |L L^T - D| <= 2 (n0 + 1) eps |L| |L|^T on the
    lower triangle (both factorizations read only that triangle of D,
    whose einsum-built upper triangle differs by round-off) and
    |L^-1 L - I| <= 2 n0 eps |L^-1| |L|, entry by entry."""
    from repro_torch.kernels.hck_leaf.ops import leaf_factor
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_factor_ref

    lo, li = leaf_factor(dleaf)
    wlo, wli = hck_leaf_factor_ref(dleaf)
    sync()
    rel = check_rel("leaf_factor L", lo, wlo, rtol)
    require(bool(torch.isfinite(li).all()), "leaf_factor L^-1 finite")
    rel_inv = rel_max(li, wli)
    if dleaf.dtype == torch.float64:
        require(rel_inv <= rtol, f"leaf_factor L^-1 rel {rel_inv:.3e}")
    n0 = dleaf.shape[-1]
    eps = torch.finfo(dleaf.dtype).eps
    back = (lo @ lo.mT - dleaf).tril().abs()
    require(bool((back <= 2 * (n0 + 1) * eps * (lo.abs() @ lo.abs().mT))
                 .all()), "leaf_factor |L L^T - D| <= 2 (n0+1) eps |L||L|^T")
    eye = torch.eye(n0, dtype=dleaf.dtype, device=dleaf.device)
    inv_err = (li @ lo - eye).abs()
    require(bool((inv_err <= 2 * n0 * eps * (li.abs() @ lo.abs())).all()),
            "leaf_factor |L^-1 L - I| <= 2 n0 eps |L^-1||L|")
    scale = float(dleaf.abs().max())
    return (rel, rel_inv, float((lo - wlo).abs().max()),
            float(back.max()) / scale, float(inv_err.max()))


def check_leaf(kind, args, rtol):
    """B4 (kind "solve") or B5 ("matvec") against its plain version: each
    output is a chain of length-n0 and length-r dot products summed in
    other orders; rtol 1e-4 relative in float32 (the documented f32
    matvec/solve bound), 1e-10 in float64."""
    from repro_torch.kernels.hck_leaf import ops, ref

    kernel = ops.leaf_solve if kind == "solve" else ops.leaf_matvec
    plain = (ref.hck_leaf_solve_ref if kind == "solve"
             else ref.hck_leaf_matvec_ref)
    got, want = kernel(*args), plain(*args)
    sync()
    rel = max(check_rel(f"leaf_{kind} {part}", g, w, rtol)
              for part, g, w in zip(("x/y", "c"), got, want))
    return rel, max(float((g - w).abs().max()) for g, w in zip(got, want))


def check_project(u, b):
    """B6 on the card against its plain version.  Tolerance: each entry is
    a length-n0 dot product, so both results lie within n0*eps*(|U|^T|b|)
    of the exact value (any summation order); they differ by at most
    twice that, entry by entry."""
    from repro_torch.kernels.hck_leaf.ops import leaf_project
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_project_ref

    got = leaf_project(u, b)
    want = hck_leaf_project_ref(u, b)
    sync()
    eps = torch.finfo(u.dtype).eps
    tol = 2 * u.shape[1] * eps * hck_leaf_project_ref(u.abs(), b.abs())
    err = (got - want).abs()
    require(bool(torch.isfinite(got).all()), "leaf_project output finite")
    require(bool((err <= tol).all()), "leaf_project within 2*n0*eps*|U|^T|b|")
    return float(err.max())


def check_contract(args, *, name, rtol):
    """B7 on the card against its plain version: max |dz| <= rtol *
    max |z_plain|.  The kernel sums (p - x)^2 directly, the plain version
    uses the ||p||^2 + ||x||^2 - 2 p.x identity, which loses about
    eps * (||p||^2 + ||x||^2) per distance, and the two sum in other
    orders; rtol is 1e-4 in float32 (the documented f32 bound of
    predictions) and 1e-10 in float64."""
    from repro_torch.kernels.oos_stage.ops import oos_contract
    from repro_torch.kernels.oos_stage.ref import oos_contract_ref

    got = oos_contract(*args, name=name, sigma=SIGMA)
    want = oos_contract_ref(*args, name=name, sigma=SIGMA)
    sync()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    require(bool(torch.isfinite(got).all()), f"oos_contract[{name}] finite")
    require(err <= rtol * scale,
            f"oos_contract[{name}] max|dz| {err:.3e} <= {rtol} * {scale:.3e}")
    return err, scale


def bucket_inputs(f, plan, queries):
    """The oos_local / oos_walk launch arguments of one 4096-query bucket,
    exactly as apply_plan builds them."""
    from repro_torch.core.partition import group_by_leaf, route

    leaf = route(f.tree, queries)
    order, _, _ = group_by_leaf(leaf, f.num_leaves)
    ls = leaf[order].contiguous()
    qs = queries[order].contiguous()
    xb = f.x_sorted.view(f.num_leaves, f.leaf_size, D)
    local = (xb, plan.w_leaf, qs, ls, ls)
    walk = (f.landmarks[-1], plan.c_tilde, qs, (ls >> 1).contiguous(), ls)
    return local, walk


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    """Phase 1: the card's name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say(f"[1 device] {smi}")
    say(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")
    return kind, smi


def phase_build() -> None:
    """Phase 2: nvcc builds every kernel of the paths, all in parallel."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    say(f"[2 build] {', '.join(_build.KERNELS)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[2 build] {name}: {line.strip()}")


def phase_fit(dev) -> dict:
    """Phase 3: the full-width fit through ``krr.fit`` with its launch
    counts, then the same fit stage by stage (timed)."""
    from repro_torch.core import hmatrix, krr, oos
    from repro_torch.core.hck import build_hck
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.core.partition import build_partition, pad_points

    gen = torch.Generator(device=dev).manual_seed(SEED)
    x, labels, xt, yt = make_data(N_TRAIN, N_TEST, dev, gen)
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    opts = dict(kernel=ker, lam=LAM, rank=RANK, leaf_size=LEAF,
                classification=True)
    sync()
    torch.cuda.reset_peak_memory_stats()

    # ---- the fit path: counts set to 0 just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    model = krr.fit(x, labels, generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), **opts)
    sync()
    t_fit = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated() / 2**30

    expected = {"gram_chol": LEVELS + 1, "cross_solve": LEVELS,
                "leaf_factor": 1, "leaf_solve": 3, "leaf_matvec": 3,
                "hck_leaf_project": 1, "oos_contract": 0}
    require(launches == expected,
            f"fit launches {launches} == expected {expected}")
    require(all(v == 0 for v in plain_calls.values()),
            f"no plain version ran on the fit path: {plain_calls}")
    f = model.factors
    require(f.n == LEAF << LEVELS and f.levels == LEVELS, "fit tree shape")
    require(bool(torch.isfinite(model.alpha).all()), "alpha finite")
    say(f"[3 fit] krr.fit n={N_TRAIN} -> {f.n} d={D} levels={f.levels} "
        f"leaf={f.leaf_size} r={f.rank} k={N_CLASSES} lam={LAM} "
        f"sigma={SIGMA} jitter={JITTER}: {t_fit:.3f} s (first call), peak "
        f"device memory {peak:.2f} GiB")
    say(f"[3 fit] launches on the fit path: {launches}; plain versions "
        f"called: {plain_calls}")

    # the same fit, stage by stage, from the same generator seed
    stages = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def timed(stage, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        stages[stage] = time.perf_counter() - t
        return out

    xp, yp, _ = timed("pad_points", lambda: pad_points(
        x, labels, LEAF, LEVELS, generator=gen))
    timed("build_partition (inside build_hck)", lambda: build_partition(
        xp, LEVELS, generator=torch.Generator(device=dev).manual_seed(9)))
    fs = timed("build_hck", lambda: build_hck(
        xp, levels=LEVELS, rank=RANK, kernel=ker, generator=gen))
    y_sorted = one_vs_all(yp, x.dtype)[fs.tree.perm]
    inv, lo = timed("invert_with_leaf",
                    lambda: hmatrix.invert_with_leaf(fs, LAM))
    alpha = timed("solve_with_inverse", lambda: hmatrix.solve_with_inverse(
        fs, inv, y_sorted, ridge=LAM))
    timed("prepare", lambda: oos.prepare(fs, alpha))
    gap = rel_max(alpha, model.alpha)
    require(gap <= 1e-6, f"staged fit reproduces krr.fit: rel {gap:.3e}")
    # relative residual ||(K + lam I) alpha - y|| / ||y|| through the
    # port's matvec, evaluated in f32 and on a float64 copy of the factors
    rres = {}
    for tag, ff, a, y in (("f32", fs, alpha, y_sorted),
                          ("f64", to_f64(fs), alpha.double(),
                           y_sorted.double())):
        r = y - hmatrix.matvec(ff, a) - LAM * a
        rres[tag] = float(torch.linalg.vector_norm(r)
                          / torch.linalg.vector_norm(y))
    # Kernel values of this data concentrate at exp(-2), so K is nearly
    # 0.135 * ones + 0.86 * I and ||K|| ~ 0.135 n; an f32 residual carries
    # ~eps32 * ||K|| of evaluation noise and refinement stops there.  The
    # gate is that floor, 1e-2; the n = 4,096 phase gates 1e-4.  ||K 1|| /
    # ||1|| (a lower bound on ||K||) is printed beside it.
    ones = torch.ones((fs.n, 1), dtype=torch.float64, device=dev)
    knorm = float(torch.linalg.vector_norm(hmatrix.matvec(to_f64(fs), ones))
                  / math.sqrt(fs.n))
    require(rres["f64"] <= 1e-2, f"fit residual {rres} <= 1e-2")
    say("[3 fit] stage wall times (warm, synchronised): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in stages.items()))
    say(f"[3 fit] staged fit vs krr.fit alpha rel {gap:.3e}; relative "
        f"residual ||(K + lam I) alpha - y|| / ||y|| through the port's "
        f"matvec: {rres['f32']:.3e} evaluated in f32, {rres['f64']:.3e} on "
        f"a float64 copy of the factors (gate 1e-2, the f32 noise floor "
        f"at this n: ||K 1|| / ||1|| = {knorm:.4e}, times eps32 "
        f"{knorm * torch.finfo(torch.float32).eps:.3e}) ok")
    return {"model": model, "launches": launches, "xt": xt, "yt": yt,
            "x": x, "labels": labels,
            "inv": inv, "b": y_sorted.view(f.num_leaves, LEAF, N_CLASSES),
            "t_fit": t_fit, "stages": stages, "peak": peak, "resid": rres}


def phase_kernels(fit, dev) -> dict:
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.kernels.build_stage.ref import build_cross_ref

    model, res = fit["model"], {}
    f = model.factors
    args = fit_launches(f, fit["inv"], fit["b"])
    # B1 at the largest Sigma level (with its factor) and for the leaves
    lm_args, leaf_args = args["gram"][LEVELS - 1], args["gram"][-1]
    res["gram_chol"] = max(check_build(*lm_args, 1e-4)[1],
                           check_build(*leaf_args, 1e-4)[1])
    say(f"[4 kernels] gram_chol Sigma {tuple(lm_args[0].shape)} with chol "
        f"and Adiag {tuple(leaf_args[0].shape)}: max|d| "
        f"{res['gram_chol']:.3e} (tolerance 1e-4 relative) ok")
    errs = [check_cross(a, None) for a in (args["cross"][0],
                                           args["cross"][-1])]
    res["cross_solve"] = max(e[1] for e in errs)
    say(f"[4 kernels] cross_solve U {tuple(args['cross'][0][0].shape)} and "
        f"W {tuple(args['cross'][-1][0].shape)} r={RANK}: rel "
        f"{max(e[0] for e in errs):.3e}, max|d| {res['cross_solve']:.3e} "
        f"(componentwise 4 (2r + d) eps |K||Linv^T||Linv|) ok")
    # the same gap between the plain version in f32 and in f64: it is the
    # f32 round-off of U, amplified by kappa(Sigma) of the parent
    u_args = args["cross"][0]
    plain_gap = rel_max(build_cross_ref(*u_args),
                        build_cross_ref(*(t.double() for t in u_args)))
    kappa = float(torch.linalg.cond(f.sigma[-1].double()).max())
    say(f"[4 kernels] cross_solve U: plain f32 vs plain f64 on the same "
        f"inputs rel {plain_gap:.3e}; max kappa(Sigma) at the leaves' "
        f"parents {kappa:.4e}")
    rel, rel_inv, res["leaf_factor"], back, inv_err = check_factor(
        args["dleaf"], 1e-4)
    say(f"[4 kernels] leaf_factor {tuple(args['dleaf'].shape)}: L rel "
        f"{rel:.3e} (tolerance 1e-4), L^-1 rel {rel_inv:.3e} (not gated "
        f"alone), max|L L^T - D| / max|D| {back:.3e}, max|L^-1 L - I| "
        f"{inv_err:.3e} (componentwise bounds) ok")
    for kind in ("solve", "matvec"):
        rel, res[f"leaf_{kind}"] = check_leaf(kind, args[kind], 1e-4)
        say(f"[4 kernels] leaf_{kind} at the fit's shapes: rel {rel:.3e}, "
            f"max|d| {res[f'leaf_{kind}']:.3e} (tolerance 1e-4 relative) ok")
    res["hck_leaf_project"] = check_project(f.u, model.plan.w_leaf)
    say(f"[4 kernels] leaf_project {tuple(f.u.shape)}: max|dc| "
        f"{res['hck_leaf_project']:.3e} (tolerance 2*n0*eps*|U|^T|b| per "
        f"entry) ok")
    local, walk = bucket_inputs(f, model.plan, fit["xt"][:4096])
    for stage, a in (("oos_local", local), ("oos_walk", walk)):
        err, scale = check_contract(a, name="gaussian", rtol=1e-4)
        res[f"{stage}_err"] = err
        say(f"[4 kernels] oos_contract {stage} q={a[2].shape[0]} "
            f"m={a[0].shape[1]}: max|dz| {err:.3e} of max|z| {scale:.3e} "
            f"(tolerance 1e-4 relative) ok")
    phase_kernels_small(dev)
    return res


def phase_kernels_small(dev) -> None:
    """Phase 4, small shapes: every kernel and base kernel in f32 and f64,
    and the NaN of a block that is not positive definite."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        o = dict(dtype=dtype, device=dev)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, **o)

        def spd(p, m):
            a = rnd(p, m, m)
            return a @ a.mT / m + torch.eye(m, **o)

        tag = str(dtype)[6:]
        for name in ("gaussian", "imq", "laplace"):
            check_build(rnd(6, 24, 5), True, rtol, name=name, jitter=1e-3)
            check_cross((rnd(4, 48, 5), rnd(4, 16, 5),
                         torch.linalg.cholesky(spd(4, 16)).contiguous()),
                        rtol, name=name)
            pts, wts = rnd(8, 32, 5), rnd(16, 32, 3)
            widx = torch.randint(0, 16, (300,), generator=gen, device=dev)
            check_contract((pts, wts, rnd(300, 5), widx >> 1, widx),
                           name=name, rtol=rtol)
        _, _, _, back, inv_err = check_factor(spd(5, 40), rtol)
        li = torch.linalg.inv(torch.linalg.cholesky(spd(6, 24))).contiguous()
        check_leaf("solve", (li, rnd(6, 24, 8), rnd(3, 8, 8), rnd(6, 24, 3)),
                   rtol)
        check_leaf("matvec", (rnd(6, 24, 24), rnd(6, 24, 8), rnd(6, 24, 3)),
                   rtol)
        check_project(rnd(6, 40, 9), rnd(6, 40, 4))
        say(f"[4 kernels] {tag} small shapes: gram_chol, cross_solve and "
            f"oos_contract for gaussian, imq and laplace, leaf_factor "
            f"(backward {back:.3e}, inverse {inv_err:.3e}), leaf_solve, "
            f"leaf_matvec and leaf_project within {rtol} relative ok")
    from repro_torch.kernels.build_stage.ops import build_gram
    from repro_torch.kernels.hck_leaf.ops import leaf_factor

    # sigma 0.1 makes K(P, P) ~ I for random points; a repeated point in
    # block 1 gives it an eigenvalue ~0, which jitter*m = -0.016 makes
    # negative, while block 0 stays positive definite
    pts = torch.randn((3, 16, 5), generator=gen, device=dev)
    pts[1, 7] = pts[1, 2]
    _, chol = build_gram(pts, sigma=0.1, jitter=-1e-3)
    bad = torch.eye(16, device=dev).expand(2, 16, 16).clone()
    bad[1, 5, 5] = -1.0                         # leaf 1 is indefinite
    lo, _ = leaf_factor(bad)
    sync()
    require(bool(torch.isnan(chol[1]).any() and torch.isfinite(chol[0]).all()),
            "gram_chol: an indefinite block gives NaN, no clamp")
    require(bool(torch.isnan(lo[1]).any() and torch.isfinite(lo[0]).all()),
            "leaf_factor: an indefinite block gives NaN, no clamp")
    say("[4 kernels] an indefinite Gram block and an indefinite leaf give "
        "NaN (no pivot clamp) ok")


def phase_exact(dev) -> None:
    """Phase 5: fits at n = 4,096 against the dense oracle."""
    from repro_torch.core import hmatrix, krr, oos
    from repro_torch.core.hck import landmark_indices, to_dense
    from repro_torch.core.kernels_fn import BaseKernel

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x32, labels, xt, _ = make_data(EXACT_N, 64, dev, gen)
    # axis-aligned directions project exactly in f32 and f64, so both fits
    # split on the same values and build the same tree
    dirs = [torch.eye(D, device=dev)[(lvl + torch.arange(1 << lvl)) % D]
            for lvl in range(EXACT_LEVELS)]
    idx = [landmark_indices(1 << lvl, EXACT_N >> lvl, RANK, device=dev,
                            generator=gen) for lvl in range(EXACT_LEVELS)]
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    models = {dt: krr.fit(x32.to(dt), labels, kernel=ker, lam=LAM, rank=RANK,
                          leaf_size=LEAF, classification=True, directions=dirs,
                          landmark_index=idx)
              for dt in (torch.float64, torch.float32)}
    m64, m32 = models[torch.float64], models[torch.float32]
    f64, f32 = m64.factors, m32.factors
    require(torch.equal(f64.tree.perm, f32.tree.perm),
            "f32 and f64 fits share one tree")
    y = one_vs_all(labels, torch.float64)[f64.tree.perm]
    dense = to_dense(f64) + LAM * torch.eye(EXACT_N, dtype=torch.float64,
                                            device=dev)
    want = torch.linalg.solve(dense, y)
    rel64 = rel_max(m64.alpha, want)
    require(rel64 <= 1e-8, f"f64 fit vs dense oracle rel {rel64:.3e} <= 1e-8")
    say(f"[5 exact] n={EXACT_N} levels={EXACT_LEVELS} d={D} r={RANK} "
        f"k={N_CLASSES}: f64 fit (kernels in f64) vs (to_dense + lam I)^-1 y: "
        f"rel {rel64:.3e} <= 1e-8 ok")
    facs = {field: max(rel_max(a, b) for a, b in zip(
        getattr(f32, field), getattr(f64, field)))
        for field in ("sigma", "sigma_cho")}
    facs["adiag"] = rel_max(f32.adiag, f64.adiag)
    b = torch.randn((EXACT_N, N_CLASSES), generator=gen, device=dev)
    facs["matvec"] = rel_max(hmatrix.matvec(f32, b),
                             hmatrix.matvec(f64, b.double()))
    for field, rel in facs.items():
        require(rel <= 1e-4, f"f32 {field} vs f64 rel {rel:.3e} <= 1e-4")
    y32 = y.float()
    resid = y32 - hmatrix.matvec(f32, m32.alpha) - LAM * m32.alpha
    rres = float(torch.linalg.vector_norm(resid) / torch.linalg.vector_norm(y32))
    require(rres <= 1e-4, f"f32 fit residual {rres:.3e} <= 1e-4")
    q = xt
    gap = rel_max(m32.predict(q), m64.predict(q.double()))
    say(f"[5 exact] f32 fit vs f64 fit: factors rel "
        + ", ".join(f"{k} {v:.3e}" for k, v in facs.items())
        + f" (each <= 1e-4); f32 residual through its own matvec {rres:.3e} "
        f"<= 1e-4; f32 vs f64 predictions rel {gap:.3e} (not gated: the "
        f"solve amplifies f32 round-off by up to kappa(K + lam I))")
    # the f32 engine against the float64 Algorithm-3 oracle on its factors
    got = m32.predict(q)
    want = oos.oos_reference_batch(to_f64(f32), q.double(), ker) \
        @ m32.alpha.double()
    rel = rel_max(got, want)
    require(got.shape == (64, N_CLASSES), "exactness output shape")
    require(rel <= 1e-4, f"engine vs oracle rel {rel:.3e} <= 1e-4")
    say(f"[5 exact] f32 engine vs oos_reference_batch (f64) on 64 queries: "
        f"rel {rel:.3e} <= 1e-4 ok")


def phase_serve(fit) -> dict:
    """Phase 6: the fitted full-width model served through its engine."""
    from repro_torch.core import oos

    model, xt, yt = fit["model"], fit["xt"], fit["yt"]
    f = model.factors
    # request sizes from 1 to 4096 queries, touching every shape bucket
    sizes = [1, 3, 7, 16, 33, 64, 100, 128, 257, 512, 700, 1024, 1500, 2048,
             3000, 4096]
    sync()

    # ---- the serving path: counts set to 0 just before, read just after --
    reset_counts()
    t0 = time.perf_counter()
    eng = model.engine
    buckets = eng.warmup()
    t_setup = time.perf_counter() - t0
    lat, start = [], 0
    for s in sizes:
        t = time.perf_counter()
        z = model.predict(xt[start:start + s])
        sync()
        lat.append(time.perf_counter() - t)
        require(z.shape == (s, N_CLASSES), "request output shape")
        start += s
    t = time.perf_counter()
    full = eng(xt)
    sync()
    t_full = time.perf_counter() - t
    launches, plain_calls = read_counts()
    # ---------------------------------------------------------------------

    require(full.shape == (N_TEST, N_CLASSES), "full request shape")
    require(bool(torch.isfinite(full).all()), "full request finite")
    require(launches["oos_contract"] > 0,
            f"the serving kernel launched on the serving path: {launches}")
    require(all(v == 0 for v in plain_calls.values()),
            f"no plain version ran on the serving path: {plain_calls}")
    again = eng(xt[:4096])
    require(torch.equal(again, full[:4096]),
            "a repeated 4096-query request is bitwise the same")
    classes = model.predict_class(xt)
    acc = float((classes == yt).double().mean())
    lat_sorted = sorted(lat)
    p50 = lat_sorted[len(lat) // 2] * 1e3
    p99 = lat_sorted[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)] * 1e3
    say(f"[6 serve] fitted model n={f.n} levels={f.levels} "
        f"leaves={f.num_leaves}: engine + warmup of buckets {buckets} in "
        f"{t_setup:.3f} s")
    say(f"[6 serve] 16 requests of sizes {sizes}: {sum(sizes)} queries in "
        f"{sum(lat):.4f} s = {sum(sizes) / sum(lat):.0f} queries/s; "
        f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms (of 16)")
    say(f"[6 serve] one request of all {N_TEST} test queries: {t_full:.4f} s "
        f"= {N_TEST / t_full:.0f} queries/s")
    say(f"[6 serve] launches on this path: {launches}; plain versions "
        f"called: {plain_calls}")
    say(f"[6 serve] engine stats: {eng.stats}")
    say(f"[6 serve] test accuracy on the synthetic labels (information, not "
        f"gated): {acc:.4f} over {N_TEST} queries, {N_CLASSES} classes")

    # full-width exactness on 16 queries against the float64 oracle
    q16 = xt[:16]
    want = oos.oos_reference_batch(to_f64(f), q16.double(), model.kernel) \
        @ model.alpha.double()
    rel = rel_max(full[:16], want)
    require(rel <= 1e-4, f"full-width engine vs oracle rel {rel:.3e}")
    say(f"[6 serve] full-width engine vs oos_reference_batch (f64) on 16 "
        f"queries: rel {rel:.3e} <= 1e-4 ok")
    return {"launches": launches, "engine": eng, "qps_full": N_TEST / t_full,
            "p50_ms": p50, "p99_ms": p99}


def kernel_record(name, source, replaces, launches, err, ms, plain, bound,
                  library=None, **extra):
    """One entry of the kernels' JSON line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library, **extra}


def phase_timing(fit, res, served) -> list[dict]:
    """Phase 7: kernel, plain and library times beside the bounds."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.build_stage import ref as bref
    from repro_torch.kernels.hck_leaf import ops as lops
    from repro_torch.kernels.hck_leaf import ref as lref
    from repro_torch.kernels.oos_stage.ops import oos_contract
    from repro_torch.kernels.oos_stage.ref import oos_contract_ref

    model, fl, sl = fit["model"], fit["launches"], served["launches"]
    f = model.factors
    args = fit_launches(f, fit["inv"], fit["b"])
    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    records = []

    def per_fit(kernel, plain, launches_args, cost, reps):
        """Sum over one fit's launches of kernel, plain and bound ms; the
        largest level's launch on its own."""
        ms = [time_ms(lambda a=a: kernel(*a), reps) for a in launches_args]
        pl = [time_ms(lambda a=a: plain(*a), reps) for a in launches_args]
        bd = [bound_ms(*cost(*a)) for a in launches_args]
        return ms, pl, bd

    gram_args = [(a[0], a[1]) for a in args["gram"]]
    g = lambda p, c: bops.build_gram(p, sigma=SIGMA, jitter=JITTER,
                                     want_chol=c)
    gp = lambda p, c: bref.build_gram_ref(p, sigma=SIGMA, jitter=JITTER,
                                          want_chol=c)
    ms, pl, bd = per_fit(g, gp, gram_args, gram_cost, 5)
    big = LEVELS - 1
    records.append(kernel_record(
        "gram_chol", src + "build_stage.cu",
        tpu + "build_stage/build_stage.py:124", fl["gram_chol"],
        res["gram_chol"], sum(ms), sum(pl),
        (sum(b[0] for b in bd), max(bd, key=lambda b: b[0])[1]),
        unit=f"one fit: {len(ms)} launches",
        sigma_largest_level={"ms": ms[big], "plain_ms": pl[big],
                             "bound_ms": bd[big][0]},
        adiag={"ms": ms[-1], "plain_ms": pl[-1], "bound_ms": bd[-1][0]}))
    c = lambda p, z, li: bops.build_cross(p, z, li, sigma=SIGMA)
    cp = lambda p, z, li: bref.build_cross_ref(p, z, li, sigma=SIGMA)
    ms, pl, bd = per_fit(c, cp, args["cross"], cross_cost, 5)
    records.append(kernel_record(
        "cross_solve", src + "build_stage.cu",
        tpu + "build_stage/build_stage.py:157", fl["cross_solve"],
        res["cross_solve"], sum(ms), sum(pl),
        (sum(b[0] for b in bd), max(bd, key=lambda b: b[0])[1]),
        unit=f"one fit: {len(ms)} launches",
        u={"ms": ms[0], "plain_ms": pl[0], "bound_ms": bd[0][0]},
        w_largest_level={"ms": ms[-1], "plain_ms": pl[-1],
                         "bound_ms": bd[-1][0]}))
    dleaf = args["dleaf"]
    chain = lambda: torch.linalg.solve_triangular(
        torch.linalg.cholesky(dleaf), torch.eye(
            LEAF, device=dleaf.device).expand_as(dleaf), upper=False)
    records.append(kernel_record(
        "leaf_factor", src + "leaf_factor.cu",
        tpu + "hck_leaf/hck_leaf.py:194", fl["leaf_factor"],
        res["leaf_factor"], time_ms(lambda: lops.leaf_factor(dleaf), 10),
        time_ms(lambda: lref.hck_leaf_factor_ref(dleaf), 10),
        bound_ms(*factor_cost(dleaf)), unit="one launch",
        library_chain_ms=time_ms(chain, 10),
        library_chain="torch.linalg.cholesky + solve_triangular"))
    a = args["solve"]
    records.append(kernel_record(
        "leaf_solve", src + "leaf_solve.cu", tpu + "hck_leaf/hck_leaf.py:123",
        fl["leaf_solve"], res["leaf_solve"],
        time_ms(lambda: lops.leaf_solve(*a), 20),
        time_ms(lambda: lref.hck_leaf_solve_ref(*a), 20),
        bound_ms(*solve_cost(*a)), unit="one launch"))
    a = args["matvec"]
    records.append(kernel_record(
        "leaf_matvec", src + "leaf_matvec.cu", tpu + "hck_leaf/hck_leaf.py:70",
        fl["leaf_matvec"], res["leaf_matvec"],
        time_ms(lambda: lops.leaf_matvec(*a), 20),
        time_ms(lambda: lref.hck_leaf_matvec_ref(*a), 20),
        bound_ms(*matvec_cost(*a)), unit="one launch"))
    u, b = f.u, model.plan.w_leaf
    records.append(kernel_record(
        "hck_leaf_project", src + "hck_leaf_project.cu",
        tpu + "hck_leaf/hck_leaf.py:233", fl["hck_leaf_project"],
        res["hck_leaf_project"], time_ms(lambda: lops.leaf_project(u, b), 20),
        time_ms(lambda: lref.hck_leaf_project_ref(u, b), 20),
        bound_ms(*project_cost(u, b)),
        library=time_ms(lambda: torch.bmm(u.mT, b), 20), unit="one launch"))
    local, walk = bucket_inputs(f, model.plan, fit["xt"][:4096])
    stages = {}
    for stage, sargs in (("oos_local", local), ("oos_walk", walk)):
        stages[stage] = {
            "ms": time_ms(lambda: oos_contract(*sargs, name="gaussian",
                                               sigma=SIGMA), 50),
            "plain_ms": time_ms(lambda: oos_contract_ref(
                *sargs, name="gaussian", sigma=SIGMA), 20),
            "bound": bound_ms(*contract_cost(*sargs)),
            "max_abs_err": res[f"{stage}_err"]}
    loc = stages["oos_local"]
    walk_rec = {k: v for k, v in stages["oos_walk"].items() if k != "bound"}
    walk_rec["bound_ms"] = stages["oos_walk"]["bound"][0]
    records.append(kernel_record(
        "oos_contract", src + "oos_contract.cu",
        tpu + "oos_stage/oos_stage.py:64", sl["oos_contract"],
        loc["max_abs_err"], loc["ms"], loc["plain_ms"], loc["bound"],
        unit="one 4096-query bucket (oos_local)", oos_walk=walk_rec))
    for rec in records:
        extra = ""
        if "library_chain_ms" in rec:
            extra = (f", chain {rec['library_chain']} "
                     f"{rec['library_chain_ms']:.4f} ms")
        say(f"[7 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']} ms{extra}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), launches {rec['launches']}")
        for part in ("sigma_largest_level", "adiag", "u", "w_largest_level",
                     "oos_walk"):
            if part in rec:
                p = rec[part]
                say(f"[7 timing]   {rec['name']} {part}: kernel "
                    f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound "
                    f"{p['bound_ms']:.4f} ms")
    return records


def profile_device(what: str, fn, repeats: int, top: int) -> None:
    """Run ``fn`` ``repeats`` times unprofiled (host clock), then under
    torch.profiler: device time per run by device op, and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    t = time.perf_counter()
    for _ in range(repeats):
        fn()
    sync()
    wall_ms = (time.perf_counter() - t) * 1e3 / repeats
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        sync()
    # device-side events only: an aten op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / repeats, e.count / repeats)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        say(f"[8 profile] {what}: the profiler recorded no device time: not "
            "measured")
        return
    rows.sort(key=lambda row: -row[1])
    dev_us = sum(row[1] for row in rows)
    launches = sum(row[2] for row in rows)
    say(f"[8 profile] {what}: wall {wall_ms:.3f} ms unprofiled, device "
        f"{dev_us / 1e3:.3f} ms in {launches:.0f} device ops -> busy share "
        f"{dev_us / 1e3 / wall_ms:.3f}")
    for key, us, count in rows[:top]:
        say(f"[8 profile]   {us:11.2f} us  x{count:6.1f}  {key[:90]}")


def phase_profile(fit, eng) -> None:
    """Phase 8: where one full-width fit and one 4096-query request spend
    their device time."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel

    ker = BaseKernel("gaussian", SIGMA, JITTER)
    x, labels, dev = fit["x"], fit["labels"], fit["x"].device
    profile_device("one full-width krr.fit", lambda: krr.fit(
        x, labels, kernel=ker, lam=LAM, rank=RANK, leaf_size=LEAF,
        classification=True,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1)), 1, 16)
    reqs = itertools.cycle([fit["xt"][i * 4096:(i + 1) * 4096]
                            for i in range(5)])
    profile_device("4096-query request", lambda: eng(next(reqs)), 5, 8)


def main() -> int:
    """Run every phase; any failure raises and exits non-zero."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch import device

    dev = device.resolve("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind, _ = phase_device()
    phase_build()
    fit = phase_fit(dev)
    res = phase_kernels(fit, dev)
    phase_exact(dev)
    served = phase_serve(fit)
    kernels = phase_timing(fit, res, served)
    phase_profile(fit, served["engine"])
    say(f"[end] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
