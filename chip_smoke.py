#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA card and ``nvcc``; without a card it exits with code 1 and prints no
result.  Phases, each of which raises on failure:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every kernel of the serving path (in parallel);
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the shapes the serving path gives it, with the tolerance
              stated on its line;
  4. exact    a small random-state model (n = 4,096): the engine's f32
              predictions against the port's float64 Algorithm-3 oracle;
  5. serve    the full-width covtype model (random state) served through
              PredictEngine.from_weights / warmup / apply: 16 requests of
              mixed sizes and one of all 116,203 test queries, with the
              kernels' launch counts read around exactly this run;
  6. timing   kernel, plain-version and library times at the serving
              shapes, beside each kernel's bound;
  7. profile  torch.profiler over five 4096-query requests: device time
              per request by kernel, and the device's busy share.

The model's state is random (seeded), as an LM smoke test uses random
weights: its predictions mean nothing.  Their correctness against the JAX
reference is held by the CPU tests (tests/test_torch_*.py).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernels' JSON record.
"""
from __future__ import annotations

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
RANK, LEAF, SIGMA, JITTER = 128, 128, 1.0, 1e-5
LEVELS = 12                        # 464,809 padded to 128 * 2**12 = 524,288
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


# ---------------------------------------------------------------------------
# Random-state model
# ---------------------------------------------------------------------------

def random_model(n_train: int, levels: int, *, n_test: int, dev, seed: int):
    """A random-state HCK model at the given size, f32 on ``dev``.

    Data x ~ N(0, (2/d) I), so E||x - y||^2 = 4 sigma^2 and the gaussian
    kernel values are O(0.1).  The tree and padding are the port's own
    (pad_points, build_partition); landmarks are r distinct rows of each
    node's block.  sigma_l = G G^T / r + I with G ~ N(0, 1), and sigma_cho
    its Cholesky factor; adiag is drawn the same way.  W entries are
    N(0, 1/(2r)), so E||W^T (e_left + e_right)||^2 = ||e||^2 and the
    upward pass over the 11 W levels neither grows nor vanishes; U entries
    are N(0, 1/n0), so U^T alpha keeps alpha's scale.  alpha ~ N(0, 1)
    with k = 7 columns (one-vs-all covtype).
    """
    from repro_torch.core.hck import HCKFactors
    from repro_torch.core.partition import build_partition, pad_points

    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    scale = math.sqrt(2.0 / D)
    x = scale * torch.randn((n_train, D), generator=gen, **f32)
    queries = scale * torch.randn((n_test, D), generator=gen, **f32)
    x, _, _ = pad_points(x, None, LEAF, levels, generator=gen)
    x_sorted, tree = build_partition(x, levels, generator=gen)
    n = x_sorted.shape[0]

    def spd(count: int, m: int) -> torch.Tensor:
        g = torch.randn((count, m, m), generator=gen, **f32)
        eye = torch.eye(m, **f32)
        return torch.bmm(g, g.mT) / m + eye

    landmarks, sigma, sigma_cho = [], [], []
    for lvl in range(levels):
        blocks = x_sorted.view(1 << lvl, n >> lvl, D)
        pick = torch.rand((1 << lvl, n >> lvl), generator=gen, device=dev)
        idx = torch.argsort(pick, dim=1)[:, :RANK]
        landmarks.append(torch.gather(
            blocks, 1, idx[:, :, None].expand(-1, -1, D)).contiguous())
        s = spd(1 << lvl, RANK)
        sigma.append(s)
        sigma_cho.append(torch.linalg.cholesky(s))
    w = tuple(torch.randn((1 << lvl, RANK, RANK), generator=gen, **f32)
              / math.sqrt(2 * RANK) for lvl in range(1, levels))
    u = torch.randn((1 << levels, LEAF, RANK), generator=gen, **f32) \
        / math.sqrt(LEAF)
    factors = HCKFactors(x_sorted, tree, tuple(landmarks), tuple(sigma),
                         tuple(sigma_cho), w, u, spd(1 << levels, LEAF))
    alpha = torch.randn((n, N_CLASSES), generator=gen, **f32)
    return factors, alpha, queries


def to_f64(f):
    """A float64 copy of factors ``f`` (for the oracle)."""
    from repro_torch.core.hck import HCKFactors
    from repro_torch.core.partition import PartitionTree

    d = lambda t: t.double()
    tr = f.tree
    return HCKFactors(
        d(f.x_sorted), PartitionTree(tr.perm, tuple(map(d, tr.directions)),
                                     tuple(map(d, tr.thresholds))),
        tuple(map(d, f.landmarks)), tuple(map(d, f.sigma)),
        tuple(map(d, f.sigma_cho)), tuple(map(d, f.w)), d(f.u), d(f.adiag))


# ---------------------------------------------------------------------------
# Kernel inputs at the serving shapes, comparisons and timing
# ---------------------------------------------------------------------------

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


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time for the work on the card, and which rate bounds it."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def project_cost(u, b):
    """Bytes and flops of c = U^T b: each input read once, c written once."""
    p, n0, r = u.shape
    k = b.shape[2]
    return 4 * (p * n0 * r + p * n0 * k + p * r * k), 2 * p * n0 * r * k


def contract_cost(points, weights, queries, pidx, widx):
    """Bytes and flops of the indexed contraction for this batch: the
    distinct point and weight blocks it touches, the queries, the indices
    and the output; per (query, row) 3d flops for the distance, one for
    the epilogue and 2k for the weighted sums."""
    _, m, d = points.shape
    k = weights.shape[2]
    q = queries.shape[0]
    nbytes = (4 * (pidx.unique().numel() * m * d
                   + widx.unique().numel() * m * k + q * d + q * k)
              + 8 * 2 * q)
    return nbytes, q * m * (3 * d + 1 + 2 * k)


def check_project(u, b):
    """B6 on the card against its plain version.  Tolerance: each entry is
    a length-n0 dot product, so both results lie within n0*eps*(|U|^T|b|)
    of the exact value (any summation order); they differ by at most
    twice that, entry by entry."""
    from repro_torch.kernels.hck_leaf.ops import leaf_project
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_project_ref

    got = leaf_project(u, b)
    want = hck_leaf_project_ref(u, b)
    torch.cuda.synchronize()
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
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    require(bool(torch.isfinite(got).all()), f"oos_contract[{name}] finite")
    require(err <= rtol * scale,
            f"oos_contract[{name}] max|dz| {err:.3e} <= {rtol} * {scale:.3e}")
    return err, scale


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
    """Phase 2: nvcc builds every kernel of the path, all in parallel."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    say(f"[2 build] {', '.join(_build.KERNELS)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"[2 build] {name}: {line.strip()}")


def phase_kernels(f, plan, queries, dev) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    res = {}
    u, b = f.u, plan.w_leaf
    res["project_err"] = check_project(u, b)
    say(f"[3 kernels] leaf_project {tuple(u.shape)} x {tuple(b.shape)}: "
        f"max|dc| {res['project_err']:.3e} (tolerance 2*n0*eps*|U|^T|b| "
        f"per entry) ok")
    local, walk = bucket_inputs(f, plan, queries[:4096])
    for stage, args in (("oos_local", local), ("oos_walk", walk)):
        err, scale = check_contract(args, name="gaussian", rtol=1e-4)
        res[f"{stage}_err"] = err
        say(f"[3 kernels] oos_contract {stage} q={args[2].shape[0]} "
            f"m={args[0].shape[1]} d={args[0].shape[2]} "
            f"k={args[1].shape[2]}: max|dz| {err:.3e} of max|z| {scale:.3e} "
            f"(tolerance 1e-4 relative) ok")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        opts = dict(dtype=dtype, device=dev)
        pts = torch.randn((8, 32, 5), generator=gen, **opts)
        wts = torch.randn((16, 32, 3), generator=gen, **opts)
        xs = torch.randn((300, 5), generator=gen, **opts)
        widx = torch.randint(0, 16, (300,), generator=gen, device=dev)
        for name in ("gaussian", "imq", "laplace"):
            err, scale = check_contract((pts, wts, xs, widx >> 1, widx),
                                        name=name, rtol=rtol)
            say(f"[3 kernels] oos_contract {name} {str(dtype)[6:]} q=300 "
                f"m=32 d=5 k=3: max|dz| {err:.3e} of {scale:.3e} "
                f"(tolerance {rtol} relative) ok")
        small_u = torch.randn((6, 40, 9), generator=gen, **opts)
        small_b = torch.randn((6, 40, 4), generator=gen, **opts)
        err = check_project(small_u, small_b)
        say(f"[3 kernels] leaf_project {str(dtype)[6:]} (6, 40, 9) x "
            f"(6, 40, 4): max|dc| {err:.3e} ok")
    return res


def phase_exact(dev) -> None:
    """Phase 4: engine vs the port's float64 oracle on a small model."""
    from repro_torch.core import oos
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.serving.predict_service import PredictEngine

    f, alpha, queries = random_model(4000, 5, n_test=64, dev=dev,
                                     seed=SEED + 2)
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    eng = PredictEngine.from_weights(f, alpha, ker)
    got = eng(queries)
    want = oos.oos_reference_batch(to_f64(f), queries.double(), ker) \
        @ alpha.double()
    rel = float((got.double() - want).abs().max() / want.abs().max())
    require(got.shape == (64, N_CLASSES), "exactness output shape")
    require(rel <= 1e-4, f"engine vs oracle rel {rel:.3e} <= 1e-4")
    say(f"[4 exact] n={f.n} levels={f.levels}: engine (f32 kernels) vs "
        f"oos_reference_batch (f64) on 64 queries: rel {rel:.3e} <= 1e-4 ok")


def phase_serve(f, alpha, queries, dev) -> dict:
    """Phase 5: the full-width serving run with the launch counts."""
    from repro_torch.core import oos
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.hck_leaf import ops as leaf_ops
    from repro_torch.kernels.hck_leaf import ref as leaf_ref
    from repro_torch.kernels.oos_stage import ops as oos_ops
    from repro_torch.kernels.oos_stage import ref as oos_ref
    from repro_torch.serving.predict_service import PredictEngine

    ker = BaseKernel("gaussian", SIGMA, JITTER)
    # request sizes from 1 to 4096 queries, touching every shape bucket
    sizes = [1, 3, 7, 16, 33, 64, 100, 128, 257, 512, 700, 1024, 1500, 2048,
             3000, 4096]
    counters = (leaf_ops.leaf_project, oos_ops.oos_contract)
    plain = (leaf_ref.hck_leaf_project_ref, oos_ref.oos_contract_ref)
    torch.cuda.synchronize()

    # ---- the main path: counts set to 0 just before, read just after ----
    for c in counters:
        c.launches = 0
    for p in plain:
        p.calls = 0
    t0 = time.perf_counter()
    eng = PredictEngine.from_weights(f, alpha, ker)
    buckets = eng.warmup()
    t_setup = time.perf_counter() - t0
    lat, start = [], 0
    for s in sizes:
        t = time.perf_counter()
        z = eng(queries[start:start + s])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
        require(z.shape == (s, N_CLASSES), "request output shape")
        start += s
    t = time.perf_counter()
    full = eng(queries)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t
    launches = {"hck_leaf_project": leaf_ops.leaf_project.launches,
                "oos_contract": oos_ops.oos_contract.launches}
    plain_calls = {"hck_leaf_project_ref": leaf_ref.hck_leaf_project_ref.calls,
                   "oos_contract_ref": oos_ref.oos_contract_ref.calls}
    # ---------------------------------------------------------------------

    require(full.shape == (N_TEST, N_CLASSES), "full request shape")
    require(bool(torch.isfinite(full).all()), "full request finite")
    require(all(v > 0 for v in launches.values()),
            f"every kernel launched on the main path: {launches}")
    require(all(v == 0 for v in plain_calls.values()),
            f"no plain version ran on the main path: {plain_calls}")
    again = eng(queries[:4096])
    require(torch.equal(again, full[:4096]),
            "a repeated 4096-query request is bitwise the same")
    lat_sorted = sorted(lat)
    p50 = lat_sorted[len(lat) // 2] * 1e3
    p99 = lat_sorted[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)] * 1e3
    say(f"[5 serve] n={f.n} levels={f.levels} leaves={f.num_leaves} d={D} "
        f"r={f.rank} k={N_CLASSES}: from_weights + warmup of buckets "
        f"{buckets} in {t_setup:.3f} s")
    say(f"[5 serve] 16 requests of sizes {sizes}: {sum(sizes)} queries in "
        f"{sum(lat):.4f} s = {sum(sizes) / sum(lat):.0f} queries/s; "
        f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms (of 16)")
    say(f"[5 serve] one request of all {N_TEST} test queries: {t_full:.4f} s "
        f"= {N_TEST / t_full:.0f} queries/s")
    say(f"[5 serve] launches on this path: {launches}; plain versions "
        f"called: {plain_calls}")
    say(f"[5 serve] engine stats: {eng.stats}")

    # full-width exactness on 16 queries against the float64 oracle
    q16 = queries[:16]
    want = oos.oos_reference_batch(to_f64(f), q16.double(), ker) \
        @ alpha.double()
    rel = float((full[:16].double() - want).abs().max() / want.abs().max())
    require(rel <= 1e-4, f"full-width engine vs oracle rel {rel:.3e}")
    say(f"[5 serve] full-width engine vs oos_reference_batch (f64) on 16 "
        f"queries: rel {rel:.3e} <= 1e-4 ok")
    return {"launches": launches, "plan": eng.plan, "engine": eng,
            "qps_full": N_TEST / t_full, "p50_ms": p50, "p99_ms": p99}


def phase_timing(f, plan, queries, res, launches) -> list[dict]:
    """Phase 6: kernel, plain and library times beside the bounds."""
    from repro_torch.kernels.hck_leaf.ops import leaf_project
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_project_ref
    from repro_torch.kernels.oos_stage.ops import oos_contract
    from repro_torch.kernels.oos_stage.ref import oos_contract_ref

    u, b = f.u, plan.w_leaf
    tb, by = bound_ms(*project_cost(u, b))
    proj = {
        "name": "hck_leaf_project", "route": "cuda",
        "source": "src/repro_torch/csrc/hck_leaf_project.cu",
        "replaces": "src/repro/kernels/hck_leaf/hck_leaf.py:233",
        "launches": launches["hck_leaf_project"],
        "max_abs_err": res["project_err"],
        "ms": time_ms(lambda: leaf_project(u, b), 20),
        "plain_ms": time_ms(lambda: hck_leaf_project_ref(u, b), 20),
        "bound_ms": tb, "bound_by": by,
        "library_ms": time_ms(lambda: torch.bmm(u.mT, b), 20),
    }
    local, walk = bucket_inputs(f, plan, queries[:4096])
    stages = {}
    for stage, args in (("oos_local", local), ("oos_walk", walk)):
        tb, by = bound_ms(*contract_cost(*args))
        stages[stage] = {
            "ms": time_ms(lambda: oos_contract(*args, name="gaussian",
                                               sigma=SIGMA), 50),
            "plain_ms": time_ms(lambda: oos_contract_ref(
                *args, name="gaussian", sigma=SIGMA), 20),
            "bound_ms": tb, "bound_by": by,
            "max_abs_err": res[f"{stage}_err"]}
    contract = {
        "name": "oos_contract", "route": "cuda",
        "source": "src/repro_torch/csrc/oos_contract.cu",
        "replaces": "src/repro/kernels/oos_stage/oos_stage.py:64",
        "launches": launches["oos_contract"],
        **{key: stages["oos_local"][key] for key in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "oos_walk": stages["oos_walk"],
    }
    for rec in (proj, contract):
        say(f"[6 timing] {rec['name']}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"launches {rec['launches']}")
    w = stages["oos_walk"]
    say(f"[6 timing] oos_contract oos_walk: kernel {w['ms']:.4f} ms, plain "
        f"{w['plain_ms']:.4f} ms, bound {w['bound_ms']:.4f} ms "
        f"({w['bound_by']})")
    return [proj, contract]


def phase_profile(eng, queries) -> None:
    """Phase 7: where a 4096-query request spends its device time."""
    from torch.profiler import ProfilerActivity, profile

    reqs = [queries[i * 4096:(i + 1) * 4096] for i in range(5)]
    eng(reqs[0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for r in reqs:
        eng(r)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3 / len(reqs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in reqs:
            eng(r)
        torch.cuda.synchronize()
    # device-side events only: an aten op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / len(reqs), e.count / len(reqs))
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        say("[7 profile] the profiler recorded no device time: not measured")
        return
    rows.sort(key=lambda row: -row[1])
    dev_us = sum(row[1] for row in rows)
    launches = sum(row[2] for row in rows)
    say(f"[7 profile] 4096-query request: wall {wall_ms:.3f} ms unprofiled, "
        f"device {dev_us / 1e3:.3f} ms in {launches:.0f} device ops -> "
        f"busy share {dev_us / 1e3 / wall_ms:.3f}")
    for key, us, count in rows[:8]:
        say(f"[7 profile]   {us:9.2f} us  x{count:4.1f}  {key[:90]}")


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
    kind, _ = phase_device()
    phase_build()
    t0 = time.perf_counter()
    f, alpha, queries = random_model(N_TRAIN, LEVELS, n_test=N_TEST,
                                     dev=dev, seed=SEED)
    torch.cuda.synchronize()
    say(f"[model] random-state covtype model: n={f.n} (from {N_TRAIN}) "
        f"d={D} levels={f.levels} leaf={f.leaf_size} rank={f.rank} "
        f"k={N_CLASSES}; built in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    from repro_torch.core import oos
    plan = oos.prepare(f, alpha)
    res = phase_kernels(f, plan, queries, dev)
    phase_exact(dev)
    torch.cuda.reset_peak_memory_stats()
    served = phase_serve(f, alpha, queries, dev)
    say(f"[5 serve] peak device memory during serving "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels = phase_timing(f, served["plan"], queries, res,
                           served["launches"])
    phase_profile(served["engine"], queries)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
