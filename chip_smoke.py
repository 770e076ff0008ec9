#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a
CUDA card and ``nvcc``; without a card it exits with code 1 and prints no
result.  Phases, each of which raises on failure:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every kernel library (in parallel); each kernel
              entry's registers and spills (all eight instances of B14's
              wgmma kernel, all six of B10's tensor-core kernel, B15's
              wgmma kernel and all four of its mma.sync kernel, both of
              B3's kernel, both of B12's register-tiled kernel, all six
              of B1's grouped kernel, all eight of B2's and of B9's grouped
              tensor-core kernels, all three of B8's grouped kernel, B7's
              sixteen and B4's eight there (the bfloat16-data entries
              among them), none spilling; any ptxas C7519 line of
              build_stage and build_dist), and the wgmma (HGMMA), mma.sync
              (HMMA),
              TMA-load (UTMALDG) and mbarrier (SYNCS) instructions of the
              B14, B10, B15, B1/B2 and B8/B9 libraries (HGMMA and UTMALDG
              required of the first three, HMMA of B15's, build_stage and
              build_dist); the panel forms' libraries (leaf_factor_panel,
              build_stage_panel, build_dist_panel: B3's two entries, B1's
              and B8's two, B2's five and B9's five, none spilling; HMMA
              in the two build libraries);
 2b. lm       Zamba2-7B serving at full width in bf16 (random weights from
              SEED): B14 (``flash_attention``) and B15
              (``ssd_intra_chunk``) against their plain versions (the
              prefill's shapes and small ragged, GQA and non-causal ones;
              bf16 and f32; each B14 check names the kernel that ran and
              requires the one its shape calls for: wgmma for aligned bf16
              with D % 8 == 0, mma.sync for a misaligned view, the CUDA-
              core kernel for f32; each B15 check likewise: wgmma for
              N and P multiples of 4 up to 64 and aligned views, mma.sync
              otherwise), two requests through ``ServeSession`` (4 x 3,840
              prompt tokens + 64 greedy, 1 x 1,280 + 16) with the launch
              counts read around each prefill (B14 14 and B15 81, all of
              them their wgmma kernels) and each decode (none), the
              kernel route against the plain route (gated in f32), one
              prefill and four decode steps profiled, B14 and B15 (each
              its wgmma and mma.sync kernels in turns) timed, B15's row with the
              prefill's device time and tokens/s (their rows join phase
              9's); runs first, so that its memory is freed before the KRR
              phases;
  3. fit      the full-width covtype KRR fit through ``krr.fit`` (synthetic
              data at that width): the kernels' launch counts read around
              exactly this call; then the same fit stage by stage, timed,
              with its solve residual through the port's own matvec;
 3s. stream   streamed ingestion: (a) phase 3's data behind an
              ``ArraySource`` through ``krr.fit_streaming`` (phase 3's
              generator seed, 64 leaves a launch, chunks of 65,536 rows;
              launch counts read around exactly this call), its tree, pad
              rows and landmarks equal to phase 3's model, Sigma and Adiag
              within B1's gate, U and W within B2's componentwise gate
              (the share bit for bit printed), alpha and the predictions
              on all test queries within the f32 bound; (b) the ``susy``
              row of the paper's Table 1 at full size (4,000,000 points of
              ``regression_dataset``, 15 levels), the example's in-memory
              ``krr.fit`` and then ``krr.fit_streaming`` on the same
              generator seed (the first freed before the second), each on
              its first call and warm with its stages, peak memory, launch
              counts, test accuracy and f32 residual beside its floor eps32
              ||K 1|| / ||1|| (printed, not met at this size: ROADMAP C15),
              the two held to each other as in (a); what gates the fit:
              B1's Adiag and B2's U of 128 leaf pairs against their plain
              versions, alpha refined in float64 (PCG on the float64
              matvec, the fit's f32 inverse as preconditioner) converged
              within 100 iterations to a residual within that f32 floor,
              and the f32 alpha within 1e-2 of it;
              (c) ``launch.train.main`` in process in four modes
              (``--stream`` and ``--update 16384`` at covtype's padded size
              and width, ``--solver exact-cg`` and bench_sweep.py's 4 x 4
              ``--grid`` at n 65,536), each printed line and launch count
              checked;
 3r. rank256  rank 256, the reference benches' default, on phase 3's data
              at covtype width (leaves of 256, 11 levels): (a) krr.fit
              (launch counts read around exactly this call: B1's Sigma, B2
              and B3 on their panel forms, counted as "<kernel>_panel"),
              each kernel of the fit against its plain version at the fit's
              shapes (B1 Sigma and Adiag, B3 within 1e-4, B2 componentwise,
              B4-B6 at n0 = r = 256); (b) its residual and test accuracy
              beside rank 128's (printed); (c) serving all test queries
              through its engine (B7 once a bucket) within 1e-4 of the
              plain path; (d) one sigma row of the sweep (B8, B9 and B3's
              stacked launch on their panel forms, counted) against the
              plain versions; (e) the f64 fit at rank and leaf 256 (8,192
              points) and its kernels against the plain versions; (f)
              every panel kernel at ragged shapes (m 236, 241, 300, 511,
              512 in f32 and 164, 170, 256, 512 in f64 for B1, B3, B8;
              r 129, 200, 256 for B2, B9), each launch on the form its
              planner names, and an indefinite tile on B1's and B3's panel
              forms giving NaN;
  4. kernels  each kernel against its plain PyTorch version on the card, at
              the shapes the fit and serving paths give it (f32; B1 and B2
              as the fit's two grouped launches, every level gated; B7 one
              stage at a time and both terms in one launch) and at a small
              shape (f64), with the tolerance stated on its line; B3's L
              and L^-1 (and B13's) exactly zero above the diagonal, which
              B4 skips; B4 where it stages Linv and U and where it reads
              them in place (n0 17, 142, 240, k 1, 7, 16, S = P and P/2);
              B7 at d 90 and 780 and in chunks of rows, and its NaN rows
              for indices out of range;
              B5 also at k 1 and 12 on the fit's leaves (a Lanczos
              step's and the sweep's KPCA block's widths), and at small
              shapes, panels of 16 rows among them;
              B1 and B2 also grouped over ragged levels at d 5 and 90 (f32
              and f64), at the grown leaves n0 142 and 167 through
              leaf_stage_factors, and in an f64 build_hck at d 90 against
              the plain path on the CPU; B3 also at n0 142, 167 and 240
              (f32) and 169 (f64), and with an indefinite pivot in its last
              panel;
  5. exact    an n = 4,096 fit at covtype width in f64 against the dense
              oracle, the f32 fit against the f64 one on the same tree and
              landmarks, and the f32 engine against the f64 Algorithm-3
              oracle; the f32 fit, the same fit under the bf16 policy
              and an ssd_chunked call again under
              set_float32_matmul_precision("high"), bit for bit the same
              (the entry points keep TF32 off);
  6. serve    the fitted full-width model served through ``model.engine``
              (warmup, 16 requests of mixed sizes and one of all 116,203
              test queries), the launch counts read around exactly this
              run (one B7 launch a bucket, both terms, and nothing else),
              and its test accuracy;
 6b. registry  health probes, recovery ladders, fault injection and the
              versioned serving registry on phase 3's full-width model:
              ``krr.fit`` with ``SolveConfig(checks=True)`` against checks
              off (the same launches, the same weights bit for bit; its
              wall-time overhead in 12 adjacent pairs with their spread,
              and its extra device ops); ``_invert_tail`` with ``solve``
              against ``solve_ex`` in 12 pairs (bits equal);
              ``launch.serve.main(["--task", "krr", ...])`` in-process at
              covtype width (116,203 queries in micro-batches of 4,096,
              16,384 arrivals published mid-stream, a rollback to v1: no
              failure, retry, degraded batch or deadline miss, versions in
              order [1, 2, 1], v1 bitwise after the rollback; p50/p99 of
              whole ``loop.serve`` calls) beside phase 6's raw engine, and
              the loop against the raw engine in 12 pairs; then faults at
              full width, the launch counts read around each call: a NaN in
              U (``probe_factors``' stage and statistic, ``repair_factors``
              within 1e-4 of the clean model's predictions), an indefinite
              leaf (``invert_guarded`` recovers), a poisoned model behind a
              canary of 1,024 held-back queries aimed at the poisoned leaf
              (rejected, registry unchanged) and behind an unaimed one
              (rejected exactly when one of its queries routes there), a
              ``FlakyEngine`` in the live entry (retries, then one degraded
              batch from v1) and ``update_and_publish(guarded=True)`` over a
              poisoned cached inverse (recovered; the audit of that publish
              printed);
  7. sweep    the sigma x lambda sweep engine at covtype width:
              ``build_sweep_plan`` once, ``gp.mle_grid`` over the 4 x 4
              grid, ``krr.fit_path`` over the 4 lambdas scored on the test
              set, the best model served for a few requests, ``kpca_fit``
              and a transform; the launch counts read around exactly this
              path (per sigma one grouped B8 launch for the Sigma levels,
              one B8 gram_dist launch for the leaves, one grouped B9 launch
              for U and W), each stage timed;
  8. gates    the sweep's kernels B8 and B9 against their plain versions
              (every level of the grouped launches at covtype shapes in
              f32; ragged groups and the one-group launches at small
              shapes, f32 and f64; NaN for an indefinite tile), the
              sweep's factors against ``build_hck``'s (bit for bit at full
              width in f32), ``invert_multi`` against
              ``invert_with_leaf``, the NLL surface against the dense
              oracle (n = 4,096) and, at full width, against the naive
              per-point path on the sweep's own factors (with the two
              factor sets' NLL in f64 equal), ``fit_path``
              against ``krr.fit``, KPCA against its dense oracle;
 8b. solvers  the exact-kernel solvers: B10 (``kernel_matvec``) and B11
              (``pairwise_kernel``) against their plain versions (covtype,
              ragged and wide shapes, f32 and f64; each B10 check names the
              kernel that ran and requires the one its dtype, base
              kernel and width call for: the tensor-core kernel for f32
              gaussian and imq with d <= 64, the CUDA-core kernel for
              laplace, f64 and d 90; the CUDA-core kernel also on the
              covtype-width f32 gaussian and imq inputs; k 1, 16 and 160
              for the tensor-core kernel's N of 8, 16 and 32; each B11
              check one launch on its route, named by the launch counts:
              16,384^2 at d 54, the ragged 4,097 x 3,001 at d 55 through
              the threads' store and 4,097 x 3,000 through the TMA store,
              y is x with the diagonal within 1e-5 of 1, d 90 on the
              CUDA cores); at
              ``bench_cg.py``'s
              shape in f64 ``krr.fit_exact`` and EigenPro against the dense
              solve and the preconditioned and plain iteration counts;
              exact-kernel KRR at covtype width through ``krr.fit_exact``
              (launch counts read around exactly this call, every B10
              launch on the tensor-core kernel, its stages timed, its
              residual through B10) and its predictions; and
              ``gp.mle_grid(logdet="slq")`` at covtype width against the
              exact surface, with the SLQ logdet gated in f64 at n = 4,096
              (its quadrature and its probe draws apart, with a faulty
              Lanczos as control); launch counts read around every solver
              call of the phase;
  8c. lifecycle  the life of a model after its fit: B12
              (``policy_dist``) against its plain version (covtype levels,
              "l2" and "l1", f32, its register-tiled kernel bit for bit
              equal to its pair_tile kernel's; n = 4,096 f64), the
              k-means and leverage indices through it equal to the plain
              route's (f32, covtype levels 0, 6, 11); ``krr.fit(landmarks=
              "kmeans" | "leverage", rank_budget=262,080)`` at covtype
              width (launch counts read around each fit, distinct
              landmark rows, prefix masks within the budget, the f32
              residual at its floor), the kernel route against the plain
              route (n = 4,096 f64: indices, masks, factors); the sweep's
              policy axis (``replan_policy`` against a fresh k-means plan,
              budgeted ``sweep_factors`` against the k-means fit); two
              ``model.update`` rounds of 16,384 arrivals (launch counts
              read around each), gated against ``refit_frozen`` with a
              fresh inverse, solve and plan over all test queries, B13
              (``leaf_update``) and B1-B7 against their plain versions at
              the grown leaf size (B6 also at the second round's and the
              exact round's), ``downdate(insert(f)) == f``; one "stale"
              and one "exact" round;
  8d. precision  the mixed-precision policy (SolveConfig.precision): every
              bfloat16-data entry (B1, B2, B7, B8, B9) against its plain
              version at d 3, 7, 18 and 54 with data views offset by one
              element; (a) the reference's precision problem (d 5, sigma
              2, jitter 1e-4, rank 16, leaf 32) at n 4,096 built under
              each policy on one tree and landmark set, against the f64
              build at the reference's gates ("f64" bit for bit; factors
              2e-2 bf16 / 1e-4 f32, matvec and predictions 5e-2 / 1e-4,
              the bf16 solve at the ridge floor 1e-1); (b) the covtype
              fit under bf16 (jitter 1e-4, lambda 1e-1; launch counts read
              around exactly this call) against an f32 fit of the same
              settings on the same tree and landmarks, first and warm
              wall time, peak memory, the ladder's verdict on its
              inversion, and each bf16 launch of the fit and of a serving
              bucket against its plain version at the f32 gates; (c) one
              bf16 sigma of sweep_factors on phase 7's plan (counted; B8
              and B9 against plain); (d) the bf16 engine on all test
              queries (counted) against the f32 one: queries/s, p50/p99,
              the largest gap, device ops a request; (e) a bf16 fit at
              lambda 1e-4 with probes on through recover.invert_guarded,
              and the bf16_ridge_floor fault detected and recovered by
              promotion; (f) launch.train --precision bf16 (covtype's
              padded size and width) and f64 (n 65,536), lines and counts
              checked; each bf16 entry timed in turns with its f32 entry
              beside its bound (bf16 data at 2 bytes);
 8e. tuning   the tuning and launch surface, on the run's own tile
              database (``REPRO_TILE_DB``, a temporary file set before
              phase 1): (a) ``autotune_all`` at the reference's default
              shape and at the covtype fit's shapes, counted: every
              "cuda" candidate runs (the stages that factor a whole tile
              on their panel forms at the default shape's n0 256), B11
              launches
              through the ``pairwise_kernel`` stage, a second call is a
              cache hit that launches nothing; each record's rates and
              roofline against the nominal and the calibrated H100 model;
              (c) a measured ``leaf_block`` steers B7 on phase 3's model
              (its plan's rows change, predictions within 1e-4 of the
              cold run); (b) ``corrupt_tile_db``: detected, the serving
              bucket's plan is the cold one, predictions bit for bit the
              cold run's, the next save repairs the file; (d) the
              quickstart on the card; then the database is removed;
  9. timing   kernel, plain-version and library times at the fit, serving,
              sweep, exact-solver, lifecycle and LM prefill shapes, beside
              each kernel's bound (B1's and B2's grouped launches with the
              direct sum's issue floor, B1's Sigma and Adiag as two
              launches in turns with one; B3 at the fit's and the stacked
              sweep's shapes, and in
              f64; B8's and B9's grouped launches per sigma, at the largest
              level and the top levels; B12's register-tiled kernel in turns
              with the design it replaced, per Lloyd round and at level 0;
              B10, B11 and B15 beside the bound of the tensor-core route
              they take and that of f32 CUDA cores; B11's tensor-core and
              CUDA-core kernels in turns by device time (and laplace's
              CUDA-core kernel in turns with the first design), beside the
              chain
              torch.cdist -> square -> scale -> exp; B10's
              tensor-core and CUDA-core kernels in turns, with the exact-KRR
              fit's wall time, iterations and seconds per apply; B4 and B7
              by device time (calls queued behind a spin kernel) and by
              events around calls, B7's
              one launch in turns with two; B4's bound over Linv's lower
              triangle beside the one over all of Linv, and B4's and B5's
              launches on every counted path); the panel forms at phase
              3r's rank-256 shapes (B1's Sigma launch, B2's grouped launch,
              B3 at the fit's leaves and stacked at G = 4, B8's and B9's
              launches of the sigma row) in turns with their plain
              versions, beside their bounds;
 10. profile  torch.profiler over one full-width fit, over five 4096-query
              requests and over one sigma row of the NLL surface: device
              time by kernel, and the device's busy share.

The data is synthetic (seeded), at covtype's size and width, with seven
labels from a seeded nonlinear function of x; its accuracy says nothing of
the real dataset.  The LM's weights and prompts are random (seeded); its
tokens say nothing of a trained model.  Correctness against the JAX reference is held by the
CPU tests (tests/test_torch_*.py).

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the kernels' JSON record.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# The covtype row of the reference's dataset table (copied, not imported).
N_TRAIN, N_TEST, D, N_CLASSES = 464_809, 116_203, 54, 7
RANK, LEAF, SIGMA, JITTER, LAM = 128, 128, 1.0, 1e-5, 1e-2
LEVELS = 12                        # 464,809 padded to 128 * 2**12 = 524,288
EXACT_N, EXACT_LEVELS = 4096, 5    # the dense-oracle fit: 32 leaves of 128
SEED = 0
# The sweep grid: the reference's benchmarks/bench_sweep.py defaults.
SIGMAS = (0.5, 1.0, 2.0, 4.0)
LAMS = (1e-3, 1e-2, 1e-1, 1.0)
KPCA_DIM, KPCA_ITERS = 8, 50
# Exact-kernel KRR at covtype width: f32 residuals carry eps32 ||K|| ~ 5e-3
# of evaluation noise, so CG stops at 1e-2.
EXACT_TOL, EXACT_MAXITER = 1e-2, 30
# The reference's benchmarks/bench_cg.py shape (f64): n, d, sigma, jitter
CG_N, CG_D, CG_SIGMA, CG_JITTER = 4096, 4, 2.0, 1e-6
# gp.mle_grid(logdet="slq"): probes, Lanczos steps, PCG tolerance in f32
SLQ_PROBES, SLQ_ITERS, SLQ_CG_TOL = 8, 30, 1e-3
# B10 at covtype width, f32: max |z - z_plain| <= FULL_RTOL max (K|V|).
# Read: 3e-8 (gaussian, imq), 8.1e-7 (laplace, whose distance sums ~12
# carry eps32 * 12 per kernel value); a lost 41-row tail of Y reads far
# above it (the phase prints the control).
FULL_RTOL = 2e-6
# The f64 SLQ gate at n = 4,096: SLQ runs on SLQ_DRAWS draws of SLQ_PROBES
# probes; the quadrature limit in nats per point lies between a correct
# Lanczos (7.7e-3 at sigma 4, lambda 1e-3) and one without
# reorthogonalisation (1.4e-2).  The probes' part is read densely over
# SLQ_MORE_DRAWS more draws as well; their 512 probes together must lie
# within SLQ_STD_LIMIT of their Hutchinson standard deviation (a mean of
# 512 independent forms, near Gaussian).
SLQ_DRAWS, SLQ_MORE_DRAWS = (43, 44, 45, 46), 60
SLQ_QUAD_LIMIT, SLQ_STD_LIMIT = 1e-2, 4.0
# The lifecycle phase: a global rank budget of half the 128 x 4,095
# landmark slots, 16,384 arrivals per update round, and the "stale"
# round's PCG stop at the f32 noise floor's order (section 5 of PERF.md).
LIFE_BUDGET = 262_080
UPDATE_Q = 16_384
STALE_TOL, STALE_MAXITER = 1e-2, 30
# LM serving: zamba2-7b at full width in bf16, random weights from SEED;
# two requests (batch, prompt tokens, greedy tokens), each prompt a
# multiple of the 256-token SSD chunk, prompt + decode under the published
# 4,096-token context.  Per prefill B14 runs once per shared-block
# application (layers 0, 6, ..., 78) and B15 once per Mamba2 block.
LM_ARCH = "zamba2-7b"
LM_REQUESTS = ((4, 3840, 64), (1, 1280, 16))
LM_LAUNCHES = {"flash_attention": 14, "flash_attention_wgmma": 14,
               "ssd_intra_chunk": 81, "ssd_intra_chunk_wgmma": 81}
# The float32 route's prefill: B14's CUDA-core kernel, no wgmma launch of
# B14; B15 the same as in bf16 (its inputs are float32 in both).
LM_LAUNCHES_F32 = {"flash_attention": 14, "ssd_intra_chunk": 81,
                   "ssd_intra_chunk_wgmma": 81}
# B14 in bf16 against its plain version: each output is rounded to bf16
# once from float32 sums taken in another order, so the two may sit one
# rounding step apart (2^-8 of the value, 2^-7 at a binade edge; allowed
# 2^-6) plus 1e-4 of the largest output where cancelling sums leave
# values near zero (the bf16 kernel splits P into two bf16 terms for P V,
# so P keeps ~16 bits, as the plain version's f32 P does).  In f32 (small
# shapes): 1e-5 of the largest output, summation order over up to 256
# keys and 112 features.
B14_BF16_REL, B14_BF16_FLOOR, B14_F32_RTOL = 2.0 ** -6, 1e-4, 1e-5
# B15 in f32: 1e-5 of the componentwise magnitude ((|C||B|^T * L)|X|),
# summation order over up to 256 keys and 64-128 features, and products
# in split TF32 (~2^-21 of each).
B15_RTOL = 1e-5
# Kernel route against the plain route, gated in float32 (the same random
# weights upcast): B14's f32 outputs differ from the plain version's by
# summation order (~1e-6 of each), B15's by its split TF32 products and
# summation order (~2e-7 of its magnitude), and 81 blocks amplify such
# differences; the last-token logits
# must agree within 2e-3 of the largest, and the greedy tokens wherever
# the plain route's top-2 margin exceeds twice that.  In bf16 the same
# comparison is printed, not gated: a one-step rounding flip in a few of
# B14's outputs changes later bf16 roundings, and the difference grows to
# the size of the logits over 81 blocks (0.72 of the largest on an H100,
# NVIDIA H100 80GB HBM3 at 700 W), as between any two correct bf16 routes.
LM_LOGIT_RTOL = 2e-3

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12                   # float64 outside the tensor cores
PEAK_BF16 = 989e12                 # dense bf16 on the tensor cores
PEAK_TF32 = 495e12                 # dense TF32 on the tensor cores
# 16 special-function results (exp2, rsqrt) a clock on each of 132 SMs at
# the 1.98 GHz the data sheet's rates assume (67e12 = 132 x 128 x 2 x 1.98e9)
PEAK_SFU = 16 * 132 * 1.98e9


def say(*parts) -> None:
    """Print one line of the run's record and flush it."""
    print(*parts, flush=True)


def require(cond: bool, what: str) -> None:
    """Fail the run (non-zero exit) unless ``cond``."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def sync() -> None:
    """Wait for the card (nothing to wait for without one)."""
    if torch.cuda.is_available():
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
    return x, label_of(x, g), xt, label_of(xt, g)


def label_of(pts: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """make_data's labels: the argmax of a nonlinear function of pts @ g."""
    t = pts @ g
    return torch.argmax(torch.sin(3.0 * t) + 0.5 * t * t, dim=1)


def fresh_points(q: int, seed: int, dev):
    """q new points of phase 3's distribution (make_data seeded SEED) and
    their labels under its labelling; ``seed`` draws the points."""
    g = torch.randn((D, N_CLASSES), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED))
    x = math.sqrt(2.0 / D) * torch.randn(
        (q, D), device=dev, generator=torch.Generator(device=dev)
        .manual_seed(seed))
    return x, label_of(x, g)


def one_vs_all(labels: torch.Tensor, dtype) -> torch.Tensor:
    """(n,) class labels -> (n, classes) +-1 targets, as the fit codes them."""
    classes = torch.unique(labels)
    one = torch.ones((), dtype=dtype, device=labels.device)
    return torch.where(labels[:, None] == classes[None, :], one, -one)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper (which counts its launches) by kernel name."""
    from repro_torch.kernels.build_stage import ops as build_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.hck_leaf import ops as leaf_ops
    from repro_torch.kernels.kernel_tile import ops as tile_ops
    from repro_torch.kernels.matvec_stage import ops as matvec_ops
    from repro_torch.kernels.oos_stage import ops as oos_ops
    from repro_torch.kernels.policy_stage import ops as policy_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.update_stage import ops as update_ops

    return {"gram_chol": build_ops.build_gram,
            "cross_solve": build_ops.build_cross,
            "gram_chol_levels": build_ops.build_gram_levels,
            "cross_solve_levels": build_ops.build_cross_levels,
            "gram_chol_dist": build_ops.build_gram_dist,
            "cross_solve_dist": build_ops.build_cross_dist,
            "gram_chol_dist_levels": build_ops.build_gram_dist_levels,
            "cross_solve_dist_levels": build_ops.build_cross_dist_levels,
            "leaf_factor": leaf_ops.leaf_factor,
            "leaf_solve": leaf_ops.leaf_solve,
            "leaf_matvec": leaf_ops.leaf_matvec,
            "hck_leaf_project": leaf_ops.leaf_project,
            "oos_contract": oos_ops.oos_contract,
            "kernel_matvec": matvec_ops.kernel_matvec,
            "kernel_tile": tile_ops.pairwise_kernel,
            "policy_dist": policy_ops.policy_dist,
            "leaf_update": update_ops.leaf_update,
            "flash_attention": attn_ops.flash_attention,
            "ssd_intra_chunk": ssd_ops.ssd_intra_chunk}


def plain_versions() -> list:
    """Every kernel's plain version (each counts its calls)."""
    from repro_torch.kernels.build_stage import ref as build_ref
    from repro_torch.kernels.flash_attention import ref as attn_ref
    from repro_torch.kernels.hck_leaf import ref as leaf_ref
    from repro_torch.kernels.kernel_tile import ref as tile_ref
    from repro_torch.kernels.matvec_stage import ref as matvec_ref
    from repro_torch.kernels.oos_stage import ref as oos_ref
    from repro_torch.kernels.policy_stage import ref as policy_ref
    from repro_torch.kernels.ssd_chunk import ref as ssd_ref
    from repro_torch.kernels.update_stage import ref as update_ref

    return [build_ref.build_gram_ref, build_ref.build_cross_ref,
            build_ref.build_gram_levels_ref, build_ref.build_cross_levels_ref,
            build_ref.build_gram_dist_ref, build_ref.build_cross_dist_ref,
            build_ref.build_gram_dist_levels_ref,
            build_ref.build_cross_dist_levels_ref,
            leaf_ref.hck_leaf_factor_ref, leaf_ref.hck_leaf_solve_ref,
            leaf_ref.hck_leaf_matvec_ref, leaf_ref.hck_leaf_project_ref,
            oos_ref.oos_contract_ref, matvec_ref.kernel_matvec_ref,
            tile_ref.pairwise_kernel_ref, policy_ref.policy_dist_ref,
            update_ref.leaf_update_ref, attn_ref.attention_ref,
            ssd_ref.ssd_intra_chunk_ref]


# The launch counts of one kernel of a library with several, by the key
# read_counts gives them: (wrapper, attribute).  The wrapper's total is its
# own key; the other kernels of the library took the difference.
# The bfloat16-data entries of B1, B2, B7, B8 and B9 (a mixed-precision
# policy's data) count their launches as "<kernel>_bf16".
BF16_KERNELS = ("gram_chol", "cross_solve", "gram_chol_levels",
                "cross_solve_levels", "gram_chol_dist", "cross_solve_dist",
                "gram_chol_dist_levels", "cross_solve_dist_levels",
                "oos_contract")
BF16_ZERO = {f"{k}_bf16": 0 for k in BF16_KERNELS}
# The kernels with a panel form (past the resident kernel's shared memory:
# ROADMAP Queue B) count its launches as "<kernel>_panel"; B4's instance
# for leaves past 256 rows counts its launches as "leaf_solve_wide".
PANEL_KERNELS = ("gram_chol", "cross_solve", "gram_chol_levels",
                 "cross_solve_levels", "gram_chol_dist", "cross_solve_dist",
                 "gram_chol_dist_levels", "cross_solve_dist_levels",
                 "leaf_factor", "leaf_update")
PANEL_ZERO = {**{f"{k}_panel": 0 for k in PANEL_KERNELS},
              "leaf_solve_wide": 0}
SUB_COUNTS = {"flash_attention_wgmma": ("flash_attention", "wgmma_launches"),
              "kernel_matvec_tc": ("kernel_matvec", "tc_launches"),
              "kernel_tile_tc": ("kernel_tile", "tc_launches"),
              "ssd_intra_chunk_wgmma": ("ssd_intra_chunk", "wgmma_launches"),
              "policy_dist_tiled": ("policy_dist", "tiled_launches"),
              "oos_contract_pair": ("oos_contract", "pair_launches"),
              "leaf_solve_wide": ("leaf_solve", "wide_launches"),
              **{f"{k}_bf16": (k, "bf16_launches") for k in BF16_KERNELS},
              **{f"{k}_panel": (k, "panel_launches") for k in PANEL_KERNELS}}


def reset_counts() -> None:
    """Set every kernel's launch count (the SUB_COUNTS and B5's launches by
    shape too) and plain version's call count to 0."""
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["leaf_matvec"].shapes.clear()
    for name, attr in SUB_COUNTS.values():
        setattr(wrappers[name], attr, 0)
    for fn in plain_versions():
        fn.calls = 0


def read_counts() -> tuple[dict, dict]:
    """(launches by kernel, calls by plain version).  B14's launches are
    its total ("flash_attention") and those of its wgmma kernel
    ("flash_attention_wgmma"); the mma.sync and CUDA-core kernels took the
    difference.  B10's, B11's, B15's, B3's and B12's likewise:
    "kernel_matvec" and its tensor-core kernel's ("kernel_matvec_tc"),
    "kernel_tile" and its tensor-core kernel's ("kernel_tile_tc"),
    "ssd_intra_chunk" and its wgmma kernel's ("ssd_intra_chunk_wgmma"),
    "policy_dist" and its register-tiled kernel's ("policy_dist_tiled");
    B7's launches with both terms of a bucket ("oos_contract_pair"); the
    bfloat16-data entries' of B1, B2, B7, B8 and B9 ("<kernel>_bf16")."""
    wrappers = kernel_wrappers()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    for key, (name, attr) in SUB_COUNTS.items():
        launches[key] = getattr(wrappers[name], attr)
    return launches, {fn.__name__: fn.calls for fn in plain_versions()}


def matvec_shapes() -> dict:
    """B5's launches since the counts were set to 0, by (n0, r, k)."""
    from repro_torch.kernels.hck_leaf.ops import leaf_matvec

    return {f"n0 {n0}, r {r}, k {k}": v
            for (n0, r, k), v in sorted(leaf_matvec.shapes.items())}


def counted(fn):
    """Run ``fn`` with every count set to 0 just before and read just after:
    (its result, launches by kernel, calls by plain version)."""
    reset_counts()
    out = fn()
    sync()
    launches, plain_calls = read_counts()
    return out, launches, plain_calls


def require_launches(what: str, launches: dict, plain_calls: dict,
                     expected: dict) -> None:
    """``what`` launched exactly ``expected`` (every other kernel 0 times)
    and ran no plain version.  Unless ``expected`` names it, every B12
    launch must be of its register-tiled kernel (the kernel its wrapper
    chooses for every shape of these paths in float32)."""
    want = dict.fromkeys(launches, 0)
    want.update(expected)
    if "policy_dist_tiled" not in expected:
        want["policy_dist_tiled"] = want["policy_dist"]
    require(launches == want, f"{what}: launches {launches} == expected "
            f"{want}")
    require(not any(plain_calls.values()),
            f"no plain version ran on {what}: {plain_calls}")


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

def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events),
    after ``warmup`` calls."""
    for _ in range(warmup):
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


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls queued behind a spin
    kernel (torch.cuda._sleep, ~2.5 ms of the card's time a call) that
    outlasts the host's launches, so the events around them time the
    card's work back to back, not the host's wrapper and launch time
    (which events around calls measure where the kernels are short)."""
    for _ in range(2):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def stage_timer(stages: dict):
    """``timed(stage, fn)``: run ``fn()`` between two synchronisations,
    record its wall seconds in ``stages[stage]`` and return its result."""
    def timed(stage, fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        stages[stage] = time.perf_counter() - t
        return out

    return timed


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = PEAK_F32) -> tuple[float, str]:
    """Least time for the work on the card, and which rate bounds it
    (``peak_flops``: the rate of the work's type, f32 by default)."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def kernel_flops(entries, points, d):
    """Least flops for ``entries`` gaussian kernel values among ``points``
    distinct points of width d: each point's squared norm once (2d), then
    per entry the dot product (2d), the identity |p|^2 + |z|^2 - 2 p.z (3)
    and the epilogue (1)."""
    return entries * (2 * d + 4) + points * 2 * d


def out_size(data) -> int:
    """Bytes of an output entry of a kernel fed ``data``: 4 (float32) for
    bfloat16 data (the bfloat16-data entries), else the data's own."""
    return 4 if data.dtype == torch.bfloat16 else data.element_size()


def gram_cost(points, want_chol):
    """gram_chol: points read once (bfloat16 data at 2 bytes), the Gram
    (and factor) written once; the m(m + 1)/2 distinct entries of each
    symmetric Gram, the jitter on its diagonal and m^3 / 3 for the
    factor."""
    b, m, d = points.shape
    nbytes = (points.element_size() * b * m * d
              + out_size(points) * b * m * m * (2 if want_chol else 1))
    flops = kernel_flops(b * m * (m + 1) // 2, b * m, d) + b * m
    return nbytes, flops + (b * m ** 3 / 3 if want_chol else 0)


def cross_cost(points, landmarks, linv):
    """cross_solve: inputs read once, U written once; the m x r kernel
    entries of each node and, per row, two products with the lower
    triangular Linv (r^2 flops each)."""
    b, m, d = points.shape
    r = landmarks.shape[1]
    nbytes = (points.element_size() * (b * m * d + b * r * d)
              + linv.element_size() * (b * r * r + b * m * r))
    return nbytes, kernel_flops(b * m * r, b * (m + r), d) + 2 * b * m * r * r


def gram_dist_cost(dist, want_chol):
    """gram_chol_dist / gram_dist: the cached distance tile read once, the
    Gram (and the factor) written once; the epilogue on the m(m + 1)/2
    distinct entries of each symmetric tile, the jitter on its diagonal and
    m^3 / 3 for the factor.  No distance flops: the distances are cached."""
    b, m, _ = dist.shape
    nbytes = (dist.element_size() * b * m * m
              + out_size(dist) * b * m * m * (2 if want_chol else 1))
    flops = b * m * (m + 1) // 2 + b * m
    return nbytes, flops + (b * m ** 3 / 3 if want_chol else 0)


def cross_dist_cost(dist, linv):
    """cross_solve_dist: D and Linv read once, U written once; the
    epilogue per entry and, per row, two products with the lower
    triangular Linv of r(r + 1)/2 multiply-adds each.  No distance flops."""
    b, m, r = dist.shape
    nbytes = (dist.element_size() * b * m * r
              + linv.element_size() * (b * m * r + b * r * r))
    return nbytes, b * m * r + 2 * b * m * r * (r + 1)


def tri_bytes(p, n0, s):
    """Bytes of p lower triangles of (n0, n0) row-major blocks of s-byte
    entries, in the 32-byte sectors their rows touch (a row from its start
    to its diagonal entry)."""
    row = torch.arange(p * n0, dtype=torch.int64)
    first = row * n0 * s                      # byte offset of each row
    last = first + (row % n0 + 1) * s - 1     # of its diagonal entry's end
    return 32 * int((last // 32 - first // 32 + 1).sum())


def factor_cost(dleaf):
    """leaf_factor: the lower triangle of D read, as the kernel reads it,
    in the 32-byte sectors its rows touch; L and L^-1 written whole (zeros
    above the diagonal included); n0^3 / 3 flops for each."""
    p, n0, _ = dleaf.shape
    s = dleaf.element_size()
    return tri_bytes(p, n0, s) + 2 * s * p * n0 * n0, 2 * p * n0 ** 3 / 3


def matvec_cost(adiag, u, b):
    """leaf_matvec: A, U and b read, y and c written."""
    p, n0, r = u.shape
    k = b.shape[2]
    nbytes = adiag.element_size() * (p * n0 * n0 + p * n0 * r
                                     + 2 * p * n0 * k + p * r * k)
    return nbytes, 2 * p * n0 * k * (n0 + r)


def solve_cost(linv, u, sig, b, whole_linv=False):
    """leaf_solve: Linv's lower triangle read, as the kernel reads it, in
    the 32-byte sectors its rows touch (all of Linv with ``whole_linv``,
    the count of the design it replaced), U, the Sig blocks and b read, x
    and c written; per column two products with the triangle (n0^2 flops
    each), U^T b, Sig c and U (Sig c)."""
    p, n0, r = u.shape
    k = b.shape[2]
    s = linv.element_size()
    tri = s * p * n0 * n0 if whole_linv else tri_bytes(p, n0, s)
    nbytes = tri + s * (p * n0 * r + sig.shape[0] * r * r
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
    and the output (each at its own element size: bfloat16 data at 2); the kernel values (kernel_flops: norms of the touched
    rows and the queries once) and 2k flops per (query, row) for the
    weighted sums."""
    _, m, d = points.shape
    k = weights.shape[2]
    q = queries.shape[0]
    nbytes = (points.element_size() * (pidx.unique().numel() * m * d + q * d)
              + weights.element_size() * (widx.unique().numel() * m * k
                                          + q * k)
              + 8 * 2 * q)
    rows = pidx.unique().numel() * m + q
    return nbytes, kernel_flops(q * m, rows, d) + q * m * 2 * k


def pair_cost(xl, wl, lm, ct, queries, leaf, parent):
    """Bytes and flops of the one-launch form: both terms' distinct blocks,
    and the queries, the two indices and the output once."""
    q, d = queries.shape
    k = wl.shape[2]
    b1, f1 = contract_cost(xl, wl, queries, leaf, leaf)
    b2, f2 = contract_cost(lm, ct, queries, parent, leaf)
    once = queries.element_size() * q * d + wl.element_size() * q * k
    return b1 + b2 - once - 16 * q, f1 + f2 - 2 * q * d


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
                jitter=JITTER, got=None):
    """B1 (``got``, one level of a grouped launch, else a one-group launch
    of build_gram) against its plain version.  The kernel sums (p - q)^2
    directly, the plain version uses the norm identity: in float32 the
    Gram entries differ by ~eps * (|p|^2 + |q|^2) and the factors by that
    amplified by the Cholesky's conditioning; rtol is the documented f32
    bound of the Gram-family factors, 1e-4 (1e-10 in float64).  The
    kernel's Gram is exactly symmetric."""
    from repro_torch.kernels.build_stage.ops import build_gram
    from repro_torch.kernels.build_stage.ref import build_gram_ref

    opts = dict(name=name, sigma=sigma, jitter=jitter, want_chol=want_chol)
    got = build_gram(points, **opts) if got is None else got
    want = build_gram_ref(points, **opts)
    sync()
    require(torch.equal(got[0], got[0].mT), f"gram_chol[{name}] symmetric")
    errs = [check_rel(f"gram_chol[{name}] gram", got[0], want[0], rtol)]
    if want_chol:
        errs.append(check_rel(f"gram_chol[{name}] chol", got[1], want[1],
                              rtol))
    return max(errs), float((got[0] - want[0]).abs().max())


def check_cross(args, rtol, name="gaussian", got=None, sigma=SIGMA):
    """B2 (``got``, one level of a grouped launch, else a one-group launch
    of build_cross) against its plain version.  U = K Linv^T Linv is
    amplified by kappa(Sigma), large where padding rows put near-duplicate
    landmarks in one node (phase 4 prints it), so, as the reference's
    registry argues for U and W, no relative bound holds entry by entry.
    The gate is the componentwise bound of the two products, |dU| <= 4 (2r + d) eps |K| |Linv|^T |Linv|:
    2r for the two length-r sums of each side, d for the kernel values,
    whose distances the kernel sums directly and the plain version through
    the norm identity.  In float64 also rel <= rtol (1e-10)."""
    from repro_torch.core.kernels_fn import get_kernel
    from repro_torch.kernels.build_stage.ops import build_cross
    from repro_torch.kernels.build_stage.ref import build_cross_ref

    pts, lm, linv = args
    got = build_cross(*args, name=name, sigma=sigma) if got is None else got
    want = build_cross_ref(*args, name=name, sigma=sigma)
    sync()
    require(bool(torch.isfinite(got).all()), f"cross_solve[{name}] finite")
    r, d = lm.shape[1], lm.shape[2]
    # bfloat16 data: the kernel computes in float32 on the promoted data
    kabs = get_kernel(name)(pts.to(linv.dtype), lm.to(linv.dtype),
                            sigma=sigma).abs()
    bound = (kabs @ linv.abs().mT) @ linv.abs()
    eps = torch.finfo(linv.dtype).eps
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
    require(not bool(torch.triu(li, 1).any() or torch.triu(lo, 1).any()),
            "leaf_factor: L and L^-1 exactly zero above the diagonal (B4 "
            "skips that triangle)")
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


def check_contract(args, *, name, rtol, pair=False, leaf_block=None):
    """B7 on the card against its plain version: one stage
    (``oos_contract``) or both terms of a bucket in one launch (``pair``:
    ``oos_local_walk``); max |dz| <= rtol * max |z_plain|.  The kernel
    sums (p - x)^2 directly, the plain version uses the ||p||^2 + ||x||^2
    - 2 p.x identity, which loses about eps * (||p||^2 + ||x||^2) per
    distance, and the two sum in other orders; rtol is 1e-4 in float32
    (the documented f32 bound of predictions) and 1e-10 in float64."""
    from repro_torch.kernels.oos_stage import ops, ref

    kernel = ops.oos_local_walk if pair else ops.oos_contract
    plain = ref.oos_local_walk_ref if pair else ref.oos_contract_ref
    got = kernel(*args, name=name, sigma=SIGMA, leaf_block=leaf_block)
    want = plain(*args, name=name, sigma=SIGMA)
    sync()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    what = "oos_local_walk" if pair else "oos_contract"
    require(bool(torch.isfinite(got).all()), f"{what}[{name}] finite")
    require(err <= rtol * scale,
            f"{what}[{name}] max|dz| {err:.3e} <= {rtol} * {scale:.3e}")
    return err, scale


def check_contract_nan(dev) -> None:
    """B7's NaN rule on the card: a query with a block index out of range
    (in either term of the one-launch form, or the one stage) gets a NaN
    row; every other row is the one it gets with valid indices, bit for
    bit."""
    from repro_torch.kernels.oos_stage import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    o = dict(generator=gen, device=dev)
    xl, wl = torch.randn((16, 24, 5), **o), torch.randn((16, 24, 3), **o)
    lm, ct = torch.randn((8, 12, 5), **o), torch.randn((16, 12, 3), **o)
    qs = torch.randn((64, 5), **o)
    leaf = torch.sort(torch.randint(0, 16, (64,), **o)).values
    good = ops.oos_local_walk(xl, wl, lm, ct, qs, leaf, leaf >> 1)
    for what, lf, par in (("leaf 16", 16, None), ("leaf -1", -1, None),
                          ("parent 8", None, 8)):
        bl, bp = leaf.clone(), (leaf >> 1).clone()
        if lf is not None:
            bl[7] = lf
        else:
            bp[7] = par
        z = ops.oos_local_walk(xl, wl, lm, ct, qs, bl, bp)
        one = ops.oos_contract(xl, wl, qs, bl, bl)
        sync()
        keep = torch.arange(64, device=dev) != 7
        require(bool(torch.isnan(z[7]).all()) and torch.equal(z[keep],
                                                              good[keep]),
                f"oos_local_walk ({what}): NaN row 7, the rest unchanged")
        if lf is not None:
            require(bool(torch.isnan(one[7]).all())
                    and bool(torch.isfinite(one[keep]).all()),
                    f"oos_contract ({what}): NaN row 7, the rest finite")
    say("[4 kernels] oos_contract and oos_local_walk: an index out of range "
        "(leaf 16 and -1, parent 8) gives a NaN row, every other row bit "
        "for bit unchanged ok")


def bucket_inputs(f, plan, queries):
    """The launch arguments of one 4096-query bucket exactly as apply_plan
    builds them: oos_local's and oos_walk's (one stage each) and the
    one-launch form's (both)."""
    from repro_torch.core.partition import group_by_leaf, route

    leaf = route(f.tree, queries)
    order, _, _ = group_by_leaf(leaf, f.num_leaves)
    ls = leaf[order].contiguous()
    qs = queries[order].contiguous()
    xb = f.x_sorted.view(f.num_leaves, f.leaf_size, D)
    parent = (ls >> 1).contiguous()
    local = (xb, plan.w_leaf, qs, ls, ls)
    walk = (f.landmarks[-1], plan.c_tilde, qs, parent, ls)
    pair = (xb, plan.w_leaf, f.landmarks[-1], plan.c_tilde, qs, ls, parent)
    return local, walk, pair


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, str]:
    """Phase 1: the card's name and power limit."""
    smi = card()
    kind = torch.cuda.get_device_name(0)
    say(f"[1 device] {smi}")
    say(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")
    return kind, smi


def phase_build() -> None:
    """Phase 2: nvcc builds every kernel of the paths, all in parallel; the
    registers and spills of each kernel entry, named by cu++filt (the eight
    instances of B14's wgmma kernel, DP 16 to 128, the six of B10's
    tensor-core kernel, gaussian and imq by 8, 16 and 32 columns, B15's
    wgmma kernel and the four of its mma.sync kernel, B3's two, the three
    of dist_tiled.cuh's register-tiled kernel (B12's two, B11's laplace
    one), B11's sixteen tensor-core kernels (gaussian and imq by 1 to 8
    k-steps),
    B1's six grouped kernels (f32, bf16 data and f64, with and without the
    factor), B2's and B9's eight grouped tensor-core kernels each (NT 4,
    8, 12, 16; f32 and bf16 data), B8's three grouped kernels (f32, bf16
    data, f64), B7's sixteen (f32 and bf16 data reading 1, 2 or 4
    features at a time, f64 1 or 2, each squared-L2 and L1), B4's sixteen
    (f32 and f64, Linv and U each staged or read in place, two or four
    quads of x a lane), B5's eight (f32 and f64, panels of 16 or 32 rows,
    a tile of 1 or 8 right-hand sides), B13's four (f32 and f64, panels of
    16 or 32 rows) and its panel form's two, and the panel forms of B1, B2,
    B8 and B9 in f32, f64 and for bf16 data, must all be there and none may
    spill),
    ptxas's C7519 lines of build_stage and build_dist, their count for
    B10's and B11's libraries (none allowed in B11's), and the Hopper
    instructions in the B14, B10, B11, B15, B1/B2 and B8/B9 libraries
    (HGMMA: wgmma, HMMA: mma.sync, UTMALDG: TMA loads, UTMASTG: TMA stores,
    SYNCS: mbarrier operations): B14's, B10's, B11's and B15's must hold
    wgmma and TMA loads, B11's TMA stores too, B15's, build_stage and
    build_dist (and their bf16-data libraries) mma.sync."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    say(f"[2 build] {', '.join(_build.KERNELS)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    entries = []  # (library, mangled entry name, its ptxas lines)
    for lib in ("build_stage", "build_dist", "build_stage_bf16",
                "build_dist_bf16", "build_stage_panel", "build_dist_panel",
                "build_stage_panel_bf16", "build_dist_panel_bf16"):
        for line in logs.get(lib, "").splitlines():
            if "C7519" in line:  # an injected warpgroup.arrive (none wanted)
                say(f"[2 build] {lib}: {line.strip()}")
    # B10's runtime k-step loop has its injected arrives; B11's unrolled
    # chains must have none
    for lib in ("kernel_matvec", "kernel_tile"):
        c7519 = sum("C7519" in line for line in logs.get(lib, "").splitlines())
        say(f"[2 build] {lib}: {c7519} C7519 lines (injected "
            "warpgroup.arrive)")
        require(lib != "kernel_tile" or c7519 == 0,
                f"kernel_tile has no C7519 line: {c7519}")
    for name, log in logs.items():
        head, *chunks = log.split("Compiling entry function")
        for line in head.splitlines():
            if "registers" in line:  # ptxas's notes ahead of the entries
                say(f"[2 build] {name}: {line.strip()}")
        for chunk in chunks:
            entries.append((name, chunk.split("'")[1], [
                line.strip() for line in chunk.splitlines()
                if "registers" in line or "spill" in line]))
    cufilt = Path(_build._nvcc()).with_name("cu++filt")
    labels = subprocess.run(
        [str(cufilt), "-p", *(mangled for _, mangled, _ in entries)],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.splitlines()
    # the Hopper entries of each redesigned kernel: (how many instances)
    hopper = {"flash_wgmma_kernel": 8, "matvec_tc_kernel": 6,
              "ssd_mma_kernel": 4, "ssd_wgmma_kernel": 1,
              "leaf_factor_kernel": 2, "dist_tiled_kernel": 3,
              "kernel_tile_tc_kernel": 16,
              "gram_chol_levels_kernel": 3, "cross_levels_tc_kernel": 8,
              "gram_points_kernel": 6, "cross_points_tc_kernel": 8,
              "oos_contract_kernel": 16, "leaf_solve_kernel": 16,
              "leaf_matvec_kernel": 8, "leaf_update_kernel": 4,
              "leaf_update_panel_kernel": 2,
              "leaf_factor_panel_kernel": 2, "gram_points_panel_kernel": 3,
              "cross_points_panel_kernel": 9,
              "gram_chol_levels_panel_kernel": 3,
              "cross_levels_panel_kernel": 8,
              "cross_levels_panel64_kernel": 1}
    # an entry's lines include those of the functions it calls (the panel
    # cross products are not inlined): each must show no spill
    seen = dict.fromkeys(hopper, 0)
    spills = {entry: [] for entry in hopper}
    for (name, mangled, lines), label in zip(entries, labels):
        for line in lines:
            say(f"[2 build] {name} {label}: {line}")
        if name.endswith("_panel_bf16") and ("cross64_panel" in mangled
                                             or "panel64" in mangled):
            continue    # the f64 kernels of the source, never launched there
        for entry in hopper:
            if entry in mangled:
                seen[entry] += 1
                spills[entry] += [line for line in lines if "spill" in line]
    for entry, count in hopper.items():
        require(seen[entry] == count and all(
            " 0 bytes spill stores, 0 bytes spill loads" in line
            for line in spills[entry]), f"the {count} {entry} entries do "
            f"not spill: {spills[entry]}")
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    for lib, needed in (("flash_attention", ("HGMMA", "UTMALDG")),
                        ("kernel_matvec", ("HGMMA", "UTMALDG")),
                        ("kernel_tile", ("HGMMA", "UTMALDG", "UTMASTG")),
                        ("ssd_chunk", ("HGMMA", "UTMALDG", "HMMA")),
                        ("build_stage", ("HMMA",)),
                        ("build_dist", ("HMMA",)),
                        ("build_stage_bf16", ("HMMA",)),
                        ("build_dist_bf16", ("HMMA",)),
                        ("build_stage_panel", ("HMMA",)),
                        ("build_dist_panel", ("HMMA",)),
                        ("build_stage_panel_bf16", ("HMMA",)),
                        ("build_dist_panel_bf16", ("HMMA",))):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(_build.library_path(lib))],
            capture_output=True, text=True, check=True,
            timeout=300).stdout.splitlines()
        ops = {op: sum(op in line for line in sass)
               for op in ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "SYNCS")}
        say(f"[2 build] {lib} SASS instructions: {ops}")
        require(all(ops[op] > 0 for op in needed),
                f"{lib}'s library holds {' and '.join(needed)}")


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
    fit_shapes = matvec_shapes()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated() / 2**30

    expected = {"gram_chol": 1, "cross_solve": 0, "gram_chol_levels": 1,
                "cross_solve_levels": 1,
                "gram_chol_dist": 0, "cross_solve_dist": 0,
                "gram_chol_dist_levels": 0, "cross_solve_dist_levels": 0,
                "leaf_factor": 1, "leaf_solve": 3, "leaf_matvec": 3,
                "hck_leaf_project": 1, "oos_contract": 0,
                "kernel_matvec": 0, "kernel_tile": 0, "policy_dist": 0,
                "leaf_update": 0, "flash_attention": 0,
                "flash_attention_wgmma": 0, "ssd_intra_chunk": 0,
                "kernel_matvec_tc": 0, "kernel_tile_tc": 0,
                "ssd_intra_chunk_wgmma": 0,
                "policy_dist_tiled": 0, "oos_contract_pair": 0, **BF16_ZERO,
                **PANEL_ZERO}
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
    timed = stage_timer(stages)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

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
            "x": x, "labels": labels, "matvec_shapes": fit_shapes,
            "inv": inv, "b": y_sorted.view(f.num_leaves, LEAF, N_CLASSES),
            "t_fit": t_fit, "stages": stages, "peak": peak, "resid": rres}


# ---------------------------------------------------------------------------
# Phase 3s: streamed ingestion -- covtype width, the susy row, the launcher
# ---------------------------------------------------------------------------

# The streamed fit's staging: leaves a launch, rows a partition chunk.
STREAM_LEAF_BATCH, STREAM_CHUNK = 64, 65_536
# The susy fit's f32 alpha against alpha refined in float64 (flexible PCG
# on the float64 matvec, the fit's f32 inverse as preconditioner, to
# REFINE_TOL within REFINE_ITERS iterations): ||alpha32 - alpha_ref|| /
# ||alpha_ref|| at most SUSY_FWD (alpha = 0 gives 1).
SUSY_FWD, REFINE_TOL, REFINE_ITERS = 1e-2, 1e-8, 100
# The launcher's four modes: the streamed and the in-memory fit (with an
# online update of UPDATE_Q arrivals) at covtype's padded size and width,
# exact-kernel CG and bench_sweep.py's 4 x 4 grid at its n 65,536 (d 8;
# rank 128, as phase 3's fit; phase 3r runs rank 256).
LAUNCH_N, LAUNCH_SMALL_N = LEAF << LEVELS, 65_536
# One krr.fit: B1's grouped Sigma launch and its Adiag launch, B2's grouped
# launch, B3 once, B4 and B5 three times each (the solve and two
# refinement rounds), B6 once.
FIT_LAUNCHES = {"gram_chol": 1, "gram_chol_levels": 1,
                "cross_solve_levels": 1, "leaf_factor": 1, "leaf_solve": 3,
                "leaf_matvec": 3, "hck_leaf_project": 1}


def stream_launches(n_leaves: int) -> dict:
    """The launches of one krr.fit_streaming: FIT_LAUNCHES with one B1
    build_gram and one B2 build_cross launch a group of STREAM_LEAF_BATCH
    leaves (the Adiag in the groups) and no grouped B2 for U."""
    groups = -(-n_leaves // STREAM_LEAF_BATCH)
    return dict(FIT_LAUNCHES, gram_chol=groups, cross_solve=groups)


def cross_gate(pts, lm, linv, got, want, chunk=2048):
    """B2's componentwise gate between two U (or W) stacks of the same
    nodes: |got - want| <= 4 (2r + d) eps |K| |Linv|^T |Linv| entry by
    entry (as ``check_cross``), nodes (B, m, d) against their parents'
    landmarks (B, r, d) and Linv (B, r, r), in chunks of nodes.  Returns
    (gate held, max |got - want|, share of nodes equal bit for bit)."""
    from repro_torch.core.kernels_fn import get_kernel

    r, d = lm.shape[1], lm.shape[2]
    eps = torch.finfo(pts.dtype).eps
    held, worst, same = True, 0.0, 0
    for s in range(0, pts.shape[0], chunk):
        e = slice(s, s + chunk)
        kabs = get_kernel("gaussian")(pts[e], lm[e], sigma=SIGMA).abs()
        bound = (kabs @ linv[e].abs().mT) @ linv[e].abs()
        err = (got[e] - want[e]).abs()
        held &= bool((err <= 4 * (2 * r + d) * eps * bound).all())
        worst = max(worst, float(err.max()))
        same += int((err.flatten(1) == 0).all(dim=1).sum())
    return held, worst, same / pts.shape[0]


def snapshot(model, queries) -> dict:
    """What phase 3s compares of a fitted model: its factors, alpha and its
    predictions on ``queries``, with its kernel and classes (the model
    itself may then be freed)."""
    return {"factors": model.factors, "alpha": model.alpha,
            "pred": model.predict(queries), "kernel": model.kernel,
            "classes": model.classes}


def stream_gaps(want: dict, model, queries, what: str) -> dict:
    """The streamed ``model`` against the in-memory fit's ``snapshot``:
    the tree (directions, thresholds, permutation), the points in tree
    order (pad rows among them) and the landmarks exactly; Sigma and its
    Cholesky factor and Adiag within B1's gate (1e-4 relative), U and
    every level's W within B2's componentwise gate; alpha and the
    predictions on ``queries`` within the f32 bound (1e-4 relative).
    Returns the gaps and the shares equal bit for bit."""
    from repro_torch.core.hck import sigma_linv

    fa, fb = want["factors"], model.factors
    require(torch.equal(fa.tree.perm, fb.tree.perm)
            and all(torch.equal(a, b) for a, b in zip(
                fa.tree.directions + fa.tree.thresholds,
                fb.tree.directions + fb.tree.thresholds)),
            f"{what}: the tree equals the in-memory fit's")
    require(torch.equal(fa.x_sorted, fb.x_sorted),
            f"{what}: the points in tree order, pad rows among them, equal")
    require(all(torch.equal(a, b) for a, b in zip(fa.landmarks,
                                                 fb.landmarks)),
            f"{what}: the landmarks equal")
    out = {"sigma_same": all(torch.equal(a, b) for a, b in zip(
        fa.sigma + fa.sigma_cho, fb.sigma + fb.sigma_cho))}
    out["sigma_rel"] = max(rel_max(b, a) for a, b in zip(
        fa.sigma + fa.sigma_cho, fb.sigma + fb.sigma_cho))
    out["adiag_rel"] = rel_max(fb.adiag, fa.adiag)
    out["adiag_same"] = float((fb.adiag == fa.adiag).flatten(1).all(dim=1)
                              .double().mean())
    require(out["sigma_rel"] <= 1e-4 and out["adiag_rel"] <= 1e-4,
            f"{what}: Sigma, its factor and Adiag within B1's 1e-4: {out}")
    linv = [sigma_linv(c) for c in fa.sigma_cho]
    rep = lambda t: torch.repeat_interleave(t, 2, dim=0)  # noqa: E731
    n_leaves, n0, d = fa.num_leaves, fa.leaf_size, fa.x_sorted.shape[1]
    held, out["u_err"], out["u_same"] = cross_gate(
        fa.x_sorted.view(n_leaves, n0, d), rep(fa.landmarks[-1]),
        rep(linv[-1]), fb.u, fa.u)
    require(held, f"{what}: U within B2's componentwise gate "
            f"(max |dU| {out['u_err']:.3e})")
    w_err, w_same = [], []
    for lvl in range(1, fa.levels):
        held, err, same = cross_gate(
            fa.landmarks[lvl], rep(fa.landmarks[lvl - 1]),
            rep(linv[lvl - 1]), fb.w[lvl - 1], fa.w[lvl - 1])
        require(held, f"{what}: W level {lvl} within B2's gate ({err:.3e})")
        w_err.append(err)
        w_same.append(same)
    out["w_err"] = max(w_err, default=0.0)
    out["w_same"] = min(w_same, default=1.0)
    out["alpha_rel"] = rel_max(model.alpha, want["alpha"])
    out["alpha_same"] = torch.equal(model.alpha, want["alpha"])
    out["pred_rel"] = rel_max(model.predict(queries), want["pred"])
    require(out["alpha_rel"] <= 1e-4 and out["pred_rel"] <= 1e-4,
            f"{what}: alpha and the predictions within the f32 bound 1e-4: "
            f"{out['alpha_rel']:.3e}, {out['pred_rel']:.3e}")
    return out


def gaps_text(g: dict) -> str:
    """One line of stream_gaps' readings."""
    return (f"tree, pad rows and landmarks equal; Sigma and its factor "
            f"rel {g['sigma_rel']:.3e} (bit for bit: {g['sigma_same']}), "
            f"Adiag rel {g['adiag_rel']:.3e} ({g['adiag_same']:.4f} of the "
            f"leaves bit for bit) <= 1e-4; U max |d| {g['u_err']:.3e} "
            f"({g['u_same']:.4f} of the leaves bit for bit), W max |d| "
            f"{g['w_err']:.3e} ({g['w_same']:.4f} of the nodes of its "
            f"worst level) within B2's componentwise gate; alpha rel "
            f"{g['alpha_rel']:.3e} (bit for bit: {g['alpha_same']}), "
            f"predictions rel {g['pred_rel']:.3e} <= 1e-4")


def fit_floor(model, targets) -> dict:
    """The f32 residual ||(K + lam I) alpha - y|| / ||y|| through the
    port's matvec of a fitted model whose targets in input order are
    ``targets``, beside two floors: eps32 ||K 1|| / ||1|| (``floor``, the
    f32 noise of one product K alpha when ||alpha|| ~ ||y||, as at covtype
    width) and that times ||alpha|| / ||y|| (``bwd``: the residual a
    backward-stable f32 solve may leave, eps ||K|| ||alpha||, with ||K 1|| /
    ||1|| <= ||K||)."""
    from repro_torch.core import hmatrix

    f = model.factors
    y = targets[f.tree.perm]
    out = {"res": rel_norm(y - hmatrix.matvec(f, model.alpha)
                           - model.lam * model.alpha, y),
           "floor": res_floor(model, y.device),
           "alpha_y": rel_norm(model.alpha, y)}
    out["bwd"] = out["floor"] * max(1.0, out["alpha_y"])
    return out


def rel_norm(a, b) -> float:
    """||a|| / ||b||."""
    return float(torch.linalg.vector_norm(a) / torch.linalg.vector_norm(b))


def f64_witness(model, pred, targets, xt, yt, direct: bool = False,
                sample: int = 128) -> dict:
    """What holds a full-size f32 fit to account where its f32 residual
    cannot (ROADMAP C15), on the live ``model`` whose predictions on
    ``xt`` are ``pred`` and whose targets in input order are ``targets``:
    B1's Adiag and B2's U of ``sample`` evenly spaced leaf pairs against
    their plain versions (phase 4's gates); then alpha refined in float64:
    flexible PCG on a float64 copy of the factors (the float64 matvec)
    from the f32 alpha, preconditioned by the fit's own f32 inverse, to
    REFINE_TOL within REFINE_ITERS iterations.  A wrong f32 inverse does
    not precondition a system of this condition that fast.  Readings: both
    alphas' residuals through the float64 matvec beside eps32 ||K 1|| /
    ||1||, the f32 alpha's forward error against the refined one, the
    share of test predictions of the same sign and the refined alpha's
    test accuracy.  With ``direct`` also the float64 solve of the same
    factors (``invert_with_leaf`` and ``solve_with_inverse`` through the
    float64 kernels; it needs about 2.5x the f32 fit's memory, so the card
    holds it up to 2,000,000 points) against the refined alpha.  Returns
    the readings; the caller gates them."""
    from repro_torch import device as _device
    from repro_torch.core import hmatrix, krr, oos
    from repro_torch.core.hck import sigma_linv
    from repro_torch.solvers.cg import pcg

    f, kernel, lam = model.factors, model.kernel, model.lam
    require(kernel.sigma == SIGMA and kernel.jitter == JITTER,
            "the plain versions' gates take phase 3's sigma and jitter")
    n0, d, half = f.leaf_size, f.x_sorted.shape[1], f.num_leaves // 2
    idx = torch.linspace(0, half - 1, sample, device=f.u.device).long()
    pairs = f.x_sorted.view(half, 2 * n0, d)[idx].contiguous()
    check_build(pairs.view(2 * sample, n0, d), False, 1e-4,
                got=(f.adiag.view(half, 2, n0, n0)[idx]
                     .reshape(2 * sample, n0, n0),))
    check_cross((pairs, f.landmarks[-1][idx].contiguous(),
                 sigma_linv(f.sigma_cho[-1][idx]).contiguous()), 1e-4,
                got=f.u.view(half, 2 * n0, -1)[idx])
    f64 = to_f64(f)
    y = targets.double()[f.tree.perm]
    a32 = model.alpha.double()
    ones = torch.ones((f.n, 1), dtype=torch.float64, device=y.device)
    knorm = float(torch.linalg.vector_norm(hmatrix.matvec(f64, ones))
                  / math.sqrt(f.n))
    resid = lambda a: rel_norm(  # noqa: E731
        y - hmatrix.matvec(f64, a) - lam * a, y)
    out = {"res32": resid(a32),
           "floor32": torch.finfo(torch.float32).eps * knorm}
    _device.synchronize(y.device)
    t0 = time.perf_counter()
    cg = pcg(lambda v: hmatrix.matvec(f64, v), y, ridge=lam,
             precond=lambda r: hmatrix.apply_inverse(
                 model.inverse, r.float()).double(),
             tol=REFINE_TOL, maxiter=REFINE_ITERS, x0=a32)
    _device.synchronize(y.device)
    out["t_refine"] = time.perf_counter() - t0
    a_ref = cg.x
    out.update(iters=cg.iterations, converged=bool(cg.converged),
               res_ref=resid(a_ref), fwd=rel_norm(a32 - a_ref, a_ref))
    ref = krr.HCKRegressor(kernel, f64, oos.prepare(f64, a_ref), a_ref,
                           model.classes, lam=lam)
    pred_ref = ref.predict(xt.double())
    out["acc_ref"] = float(krr.accuracy(ref.predict_class(xt.double()), yt))
    out["agree"] = float(((pred_ref > 0) == (pred > 0)).double().mean())
    del ref, pred_ref
    if direct:
        card = y.device.type == "cuda"  # tools/susy_scaling.py also on CPU
        if card:
            torch.cuda.empty_cache()
            out["held"] = torch.cuda.memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
        _device.synchronize(y.device)
        t0 = time.perf_counter()
        inv, _ = hmatrix.invert_with_leaf(f64, lam)
        a64 = hmatrix.solve_with_inverse(f64, inv, y, ridge=lam)
        _device.synchronize(y.device)
        out["t_direct"] = time.perf_counter() - t0
        del inv
        out["peak"] = (torch.cuda.max_memory_allocated() / 2**30 if card
                       else math.nan)
        out.setdefault("held", math.nan)
        out["res64"] = resid(a64)
        out["ref_vs_64"] = rel_norm(a_ref - a64, a64)
    del f64
    if y.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def witness_text(w: dict) -> str:
    """One line of f64_witness' readings."""
    text = (f"alpha refined in float64 (flexible PCG, float64 matvec, the "
            f"fit's f32 inverse as preconditioner, from the f32 alpha): "
            f"{w['iters']} iterations in {w['t_refine']:.3f} s (converged "
            f"to {REFINE_TOL}: {w['converged']}), residual {w['res_ref']:.3e}"
            f" against the f32 floor eps32 ||K 1|| / ||1|| = "
            f"{w['floor32']:.3e}; the f32 alpha: residual {w['res32']:.3e} "
            f"(float64 matvec), ||alpha32 - alpha_ref|| / ||alpha_ref|| "
            f"{w['fwd']:.3e}; test predictions of the same sign "
            f"{w['agree']:.4f}; test accuracy {w['acc_ref']:.4f} (refined "
            f"alpha); B1's Adiag and B2's U of 128 leaf pairs within phase "
            f"4's gates of their plain versions")
    if "res64" in w:
        text += (f"; the float64 solve of the same factors: "
                 f"{w['t_direct']:.3f} s, peak device memory "
                 f"{w['peak']:.2f} GiB ({w['held']:.2f} GiB held before), "
                 f"residual {w['res64']:.3e}, ||alpha_ref - alpha64|| / "
                 f"||alpha64|| {w['ref_vs_64']:.3e}")
    return text


def witness_gates(w: dict, what: str) -> None:
    """The gates of a full-size f32 fit (ROADMAP C15): the refined alpha
    converged and meets the f32 floor, and the f32 alpha lies within
    SUSY_FWD of it."""
    require(w["converged"] and w["res_ref"] <= w["floor32"],
            f"{what}: alpha refined in float64 converged to {REFINE_TOL} "
            f"within {REFINE_ITERS} iterations ({w['iters']}) and its "
            f"residual {w['res_ref']:.3e} <= the f32 floor "
            f"{w['floor32']:.3e}")
    require(w["fwd"] <= SUSY_FWD,
            f"{what}: ||alpha32 - alpha_ref|| / ||alpha_ref|| "
            f"{w['fwd']:.3e} <= {SUSY_FWD}")


def stream_covtype(fit, dev) -> dict:
    """Phase 3s (a): phase 3's training data behind an ArraySource through
    krr.fit_streaming with phase 3's generator seed, held to phase 3's
    model."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.data.pipeline import ArraySource

    src = ArraySource(fit["x"])
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    sync()
    t0 = time.perf_counter()
    # ---- the streamed fit: counts set to 0 just before, read just after --
    model, launches, plain_calls = counted(lambda: krr.fit_streaming(
        src, fit["labels"], kernel=ker, lam=LAM, rank=RANK, leaf_size=LEAF,
        classification=True, leaf_batch=STREAM_LEAF_BATCH,
        chunk_rows=STREAM_CHUNK,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1)))
    # ---------------------------------------------------------------------
    t_fit = time.perf_counter() - t0
    expected = stream_launches(1 << LEVELS)
    require_launches("krr.fit_streaming at covtype width", launches,
                     plain_calls, expected)
    base = fit["model"]
    gaps = stream_gaps(snapshot(base, fit["xt"]), model, fit["xt"],
                       "covtype streamed fit")
    acc = float(krr.accuracy(model.predict_class(fit["xt"]), fit["yt"]))
    used = {k: v for k, v in launches.items() if v}
    say(f"[3s stream] (a) krr.fit_streaming(ArraySource(phase 3's x), "
        f"leaf_batch={STREAM_LEAF_BATCH}, chunk_rows={STREAM_CHUNK}) "
        f"n={N_TRAIN} -> {model.factors.n} d={D} levels="
        f"{model.factors.levels}: {t_fit:.3f} s (first call; phase 3's "
        f"krr.fit {fit['t_fit']:.3f} s); launches {used} (exact); no plain "
        f"version called; test accuracy {acc:.4f}")
    say(f"[3s stream] (a) against phase 3's model: {gaps_text(gaps)}")
    return {"t_fit": t_fit, "gaps": gaps, "launches": launches}


def susy_fit(x, y, xt, yt, targets, *, stream: bool, want=None) -> dict:
    """Phase 3s (b): one fit of the susy row (first call, counted, then
    warm with stage times), its f32 residual beside the floors (printed:
    at this size it does not reach eps32 ||K 1|| / ||1||, ROADMAP C15;
    ``f64_witness`` gates the fit instead) and its test accuracy; with
    ``want`` (the in-memory fit's snapshot) held to it.
    Frees its models; returns the readings (and with ``want`` None the
    snapshot)."""
    from repro_torch.configs.hck_krr import DATASETS
    from repro_torch.core import krr
    from repro_torch.core.partition import auto_levels_ceil
    from repro_torch.examples import large_scale_krr

    cfg = DATASETS["susy"]
    what = "krr.fit_streaming" if stream else "krr.fit"
    opts = dict(rank=cfg.rank, lam=cfg.lam, sigma=cfg.sigma, seed=SEED + 1,
                stream=stream, leaf_batch=STREAM_LEAF_BATCH,
                chunk_rows=STREAM_CHUNK)
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # ---- the fit: counts set to 0 just before, read just after ----------
    model, launches, plain_calls = counted(
        lambda: large_scale_krr.fit(x, y, **opts))
    # ---------------------------------------------------------------------
    t_first = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    levels = model.factors.levels
    require(levels == auto_levels_ceil(cfg.n_train, cfg.leaf_size)
            and model.factors.n == cfg.leaf_size << levels,
            f"{what}: the susy row pads to {cfg.leaf_size} x 2**{levels}")
    expected = (stream_launches(1 << levels) if stream else FIT_LAUNCHES)
    require_launches(f"{what} at the susy row", launches, plain_calls,
                     expected)
    require(bool(torch.isfinite(model.alpha).all()), f"{what}: alpha finite")
    res = fit_floor(model, targets)
    acc = float(krr.accuracy(model.predict_class(xt), yt))
    out = {"t_first": t_first, "peak": peak, "held": held, "res": res,
           "acc": acc, "levels": levels,
           "launches": {k: v for k, v in launches.items() if v}}
    if want is None:
        out["snapshot"] = snapshot(model, xt)
        out["witness"] = f64_witness(model, out["snapshot"]["pred"],
                                     targets, xt, yt)
        witness_gates(out["witness"], what)
    else:
        out["gaps"] = stream_gaps(want, model, xt, f"susy {what}")
    del model
    torch.cuda.empty_cache()
    stages = {}
    sync()
    t0 = time.perf_counter()
    model = large_scale_krr.fit(x, y, timings=stages, **opts)
    sync()
    out["t_warm"] = time.perf_counter() - t0
    out["stages"] = stages
    del model
    torch.cuda.empty_cache()
    return out


def susy_text(r: dict) -> str:
    """One line of a susy fit's readings."""
    levels = [v for k, v in r["stages"].items()
              if k.startswith("partition level")]
    parts = [f"{k} {v * 1e3:.1f}" for k, v in r["stages"].items()
             if not k.startswith("partition level")]
    if levels:
        parts.insert(0, f"streamed partition {sum(levels) * 1e3:.1f} (per "
                     f"level 0..{len(levels) - 1}: "
                     f"{', '.join(f'{v * 1e3:.1f}' for v in levels)})")
    return (f"levels {r['levels']}: {r['t_first']:.3f} s first call, "
            f"{r['t_warm']:.3f} s warm; warm stages (ms, synchronised): "
            f"{'; '.join(parts)}; peak device memory {r['peak']:.2f} GiB "
            f"({r['held']:.2f} GiB held before the call); "
            f"{residual_text(r['res'])}; launches {r['launches']}; test "
            f"accuracy {r['acc']:.4f}")


def residual_text(r: dict) -> str:
    """fit_floor's readings, each limit met or not."""
    met = lambda ok: "met" if ok else "NOT met"  # noqa: E731
    return (f"f32 residual {r['res']:.3e}: against eps32 ||K 1|| / ||1|| "
            f"= {r['floor']:.3e} {met(r['res'] <= r['floor'])}, against "
            f"phase 3's fixed 1e-2 {met(r['res'] <= 1e-2)}; eps32 ||K 1|| / "
            f"||1|| ||alpha|| / ||y|| (||alpha|| / ||y|| = "
            f"{r['alpha_y']:.3f}), what a backward-stable f32 solve may "
            f"leave, {r['bwd']:.3e} (not a gate)")


def stream_susy(dev, smi) -> dict:
    """Phase 3s (b): the susy row at full size, in memory (the example's
    krr.fit) and streamed (krr.fit_streaming, the same generator seed),
    one after the other, the first freed before the second."""
    from repro_torch.configs.hck_krr import DATASETS
    from repro_torch.examples import large_scale_krr

    cfg = DATASETS["susy"]
    sync()
    t0 = time.perf_counter()
    (x, y), (xt, yt) = large_scale_krr.dataset(cfg, device=dev, seed=SEED)
    sync()
    t_data = time.perf_counter() - t0
    require(x.shape == (cfg.n_train, cfg.d) and xt.shape == (cfg.n_test,
                                                             cfg.d),
            "susy data shapes")
    # the fit's targets in input order, pad rows included (the generator's
    # first draws, as krr.fit and fit_streaming pad)
    from repro_torch.core.partition import auto_levels_ceil, pad_points

    levels = auto_levels_ceil(cfg.n_train, cfg.leaf_size)
    _, yp, _ = pad_points(x, y, cfg.leaf_size, levels,
                          generator=torch.Generator(device=dev)
                          .manual_seed(SEED + 1))
    one = torch.ones((), device=dev)
    targets = torch.where(yp == 1, one, -one)[:, None]
    mem = susy_fit(x, y, xt, yt, targets, stream=False)
    want = mem.pop("snapshot")
    st = susy_fit(x, y, xt, yt, targets, stream=True, want=want)
    del want
    torch.cuda.empty_cache()
    say(f"[3s stream] (b) {smi}: the susy row (n {cfg.n_train:,} -> "
        f"{cfg.leaf_size << levels:,}, {cfg.n_test:,} test points, d "
        f"{cfg.d}, binary; rank {cfg.rank}, leaf {cfg.leaf_size}, sigma "
        f"{cfg.sigma}, lam {cfg.lam}): regression_dataset {t_data:.3f} s")
    say(f"[3s stream] (b) in memory, the example's krr.fit: {susy_text(mem)}")
    say(f"[3s stream] (b) streamed, krr.fit_streaming(leaf_batch="
        f"{STREAM_LEAF_BATCH}, chunk_rows={STREAM_CHUNK}): {susy_text(st)}")
    say(f"[3s stream] (b) streamed against in memory: "
        f"{gaps_text(st['gaps'])}")
    say(f"[3s stream] (b) in memory, what gates the fit (the streamed "
        f"alpha is the same bits): {witness_text(mem['witness'])}")
    return {"mem": mem, "stream": st, "t_data": t_data}


def launcher_mode(argv, expected, pattern, extra=None,
                  tag="[3s stream] (c)") -> dict:
    """One in-process run of ``launch.train.main(argv)`` on the card: its
    printed lines must match ``pattern`` (a regex per line) and its
    launches equal ``expected`` (a dict, or a function of the returned
    record giving it)."""
    import io
    import re

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, launches, plain_calls = counted(lambda: train.main(argv))
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        say(f"{tag} {line}")
    require(len(lines) == len(pattern) and all(
        re.fullmatch(p, line) for p, line in zip(pattern, lines)),
        f"launch.train {' '.join(argv)} printed its lines: {lines}")
    want = expected(out) if callable(expected) else expected
    require_launches(f"launch.train {' '.join(argv)}", launches, plain_calls,
                     want)
    used = {k: v for k, v in launches.items() if v}
    say(f"{tag} launches {used} (exact); no plain version called")
    return out


def stream_launcher(dev) -> dict:
    """Phase 3s (c): launch.train --task krr in four modes, in process."""
    from repro_torch.launch import train  # noqa: F401  (imports on the card)

    num = r"[0-9.]+"
    big = ["--task", "krr", "--n", str(LAUNCH_N), "--d", str(D), "--rank",
           str(RANK)]
    fit_line = (rf"krr n={LAUNCH_N} d={D} rank={RANK} backend=auto "
                rf"\({{}}\): fit {num} s \([0-9,]+ points/s\), train rel-err "
                rf"{num}")
    one_bucket = {"oos_contract": 1, "oos_contract_pair": 1}
    t0 = time.perf_counter()
    runs = {}
    runs["stream"] = launcher_mode(
        big + ["--stream"], dict(stream_launches(1 << LEVELS), **one_bucket),
        [fit_line.format("streaming")])
    update_round = {"cross_solve": 1, "leaf_update": 1, "leaf_solve": 3,
                    "leaf_matvec": 5, "hck_leaf_project": 1}
    runs["update"] = launcher_mode(
        big + ["--update", str(UPDATE_Q)],
        {k: FIT_LAUNCHES.get(k, 0) + update_round.get(k, 0) + (
            2 if k in one_bucket else 0)
         for k in {*FIT_LAUNCHES, *update_round, *one_bucket}},
        [fit_line.format("in-memory"),
         rf"krr-update \+{UPDATE_Q} points: {num} s \([0-9,]+ inserts/s vs "
         rf"full fit [0-9,]+ points/s\), k=\d+/leaf, resid \S+, "
         rf"rebuild=(True|False), train rel-err {num}"])

    def exact_launches(out):
        # the preconditioner's build and B3 once, B10 an iteration plus the
        # initial residual, B4 an iteration plus the initial apply, and
        # B10's launches of the 2,048-query prediction
        it = out["iterations"]
        x = torch.randn((LAUNCH_SMALL_N, 8), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        _, pl, _ = counted(lambda: out["model"].predict(x[:2048]))
        b10 = it + 1 + pl["kernel_matvec"]
        return dict(FIT_LAUNCHES, leaf_solve=it + 1, leaf_matvec=0,
                    hck_leaf_project=0, kernel_matvec=b10,
                    kernel_matvec_tc=b10)

    runs["exact"] = launcher_mode(
        ["--task", "krr", "--n", str(LAUNCH_SMALL_N), "--rank", str(RANK),
         "--solver", "exact-cg"], exact_launches,
        [rf"krr-exact n={LAUNCH_SMALL_N} d=8 rank={RANK} solver=exact-cg "
         rf"backend=auto: fit {num} s in \d+ iterations \(rel resid \S+\), "
         rf"train rel-err {num}"])
    require(math.isfinite(runs["exact"]["residual"]),
            f"exact-cg residual finite: {runs['exact']['residual']}")
    sig, lam = "0.5,1,2,4", "1e-3,1e-2,1e-1,1"
    g = len(sig.split(","))
    runs["grid"] = launcher_mode(
        ["--task", "krr", "--grid", "--n", str(LAUNCH_SMALL_N), "--rank",
         str(RANK), "--sigmas", sig, "--lams", lam],
        # per sigma: B8's grouped Sigma launch and its Adiag launch, B9's
        # grouped launch, B3 once for the stacked lambdas, B4 and B5 three
        # times a lambda, B6 and B7 once (the scores); then best(): B6, B7
        {"gram_chol_dist": g, "gram_chol_dist_levels": g,
         "cross_solve_dist_levels": g, "leaf_factor": g,
         "leaf_solve": 3 * g * 4, "leaf_matvec": 3 * g * 4,
         "hck_leaf_project": g + 1, "oos_contract": g + 1,
         "oos_contract_pair": g + 1},
        [rf"sweep n={LAUNCH_SMALL_N} rank={RANK} grid=4x4 backend=auto: "
         rf"plan {num} s \+ grid {num} s \({num} grid points/s\)"]
        + [rf"  sigma=\S+ +val-relerr per lam: {num}  {num}  {num}  {num}"]
        * g + [rf"best: sigma=\S+ lam=\S+ val-relerr {num}"])
    runs["t"] = time.perf_counter() - t0
    return runs


def phase_stream(fit, dev, smi) -> dict:
    """Phase 3s: streamed ingestion and the KRR training launcher."""
    t0 = time.perf_counter()
    cov = stream_covtype(fit, dev)
    t_a = time.perf_counter() - t0
    susy = stream_susy(dev, smi)
    t_b = time.perf_counter() - t0 - t_a
    runs = stream_launcher(dev)
    t_all = time.perf_counter() - t0
    say(f"[3s stream] phase done in {t_all:.1f} s ((a) {t_a:.1f} s, (b) "
        f"{t_b:.1f} s, (c) {runs['t']:.1f} s)")
    return {"covtype": cov, "susy": susy, "launcher": runs}


# ---------------------------------------------------------------------------
# Phase 3r: rank 256, the reference benches' default -- the panel forms
# ---------------------------------------------------------------------------

# benchmarks/bench_build.py:142, bench_oos.py:112 and bench_sweep.py:126
# default to rank 256, and krr.fit's leaf is its rank: covtype at rank 256
# is 11 levels, 2,048 leaves of 256 (464,809 padded to 524,288).  The f64
# fit keeps that rank and leaf at a depth of 5 (8,192 points, 32 leaves).
RANK_R, LEVELS_R, LEVELS_R64 = 256, 11, 5
# The ragged shapes each panel kernel is held against its plain version
# at: tiles m (B1, B3, B8) past the resident forms' limits (B1 235 / 163,
# B3 and B8 240 / 169, in f32 / f64) up to the panel form's 512, and
# ranks (B2, B9) past 128 up to 256.
PANEL_M = {torch.float32: (236, 241, 300, 511, 512),
           torch.float64: (164, 170, 256, 512)}
PANEL_R = (129, 200, 256)
# One krr.fit at rank 256: FIT_LAUNCHES, with B1's Sigma launch, B2's and
# B3's on their panel forms (B1's Adiag, without a factor, has no limit).
FIT_LAUNCHES_R = dict(FIT_LAUNCHES, gram_chol_levels_panel=1,
                      cross_solve_levels_panel=1, leaf_factor_panel=1)
# One sweep_factors pass at rank 256: B8's Sigma and B9 on their panel
# forms, B8's Adiag (gram_dist) with no limit.
SWEEP_LAUNCHES_R = {"gram_chol_dist_levels": 1, "gram_chol_dist_levels_panel":
                    1, "gram_chol_dist": 1, "cross_solve_dist_levels": 1,
                    "cross_solve_dist_levels_panel": 1}


def panel_forms(dtype, m: int) -> tuple[str, str, str]:
    """The forms the wrappers' planners name for a factored (m, m) tile:
    B1's, B3's and B8's."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.hck_leaf.ops import factor_route, factor_smem

    s = torch.finfo(dtype).bits // 8
    return (bops.gram_route("phase 3r", m, s),
            factor_route("phase 3r", m, s, factor_smem),
            bops.gram_route("phase 3r", m, s, dist=True))


def check_panel_shapes(dev) -> list[str]:
    """Phase 3r (f): each panel kernel against its plain version at the
    ragged shapes (PANEL_M, PANEL_R), f32 and f64, every launch counted on
    the form its planner names: B1 grouped over levels of m 24 (resident)
    and every PANEL_M (two launches where the routes differ, one a form),
    B8 the same on cached distances, B3 a launch a size (factor_leaves'
    leaves), B2 and B9 grouped over m 48, 130 and 512 at each rank; then
    an indefinite tile on B1's and B3's panel forms gives NaN."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.hck_leaf.ops import leaf_factor

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    rows = []
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        o = dict(dtype=dtype, device=dev)
        tag = str(dtype)[6:]

        def rnd(*shape):
            return torch.randn(shape, generator=gen, **o) * math.sqrt(
                2 / shape[-1])

        ms = [24, *PANEL_M[dtype]]
        forms = [panel_forms(dtype, m) for m in ms]
        pts = [rnd(2, m, 5) for m in ms]
        n1 = len({f[0] for f in forms})
        grams, launches, plain = counted(lambda: bops.build_gram_levels(
            pts, jitter=1e-3))
        require_launches(f"{tag} gram_chol_levels at m {ms}", launches,
                         plain, {"gram_chol_levels": n1,
                                 "gram_chol_levels_panel": 1})
        e1 = max(check_build(p, True, rtol, jitter=1e-3, got=g)[1]
                 for p, g in zip(pts, grams))
        dists = [(torch.cdist(p, p) ** 2).contiguous() for p in pts]
        n8 = len({f[2] for f in forms})
        gd, launches, plain = counted(lambda: bops.build_gram_dist_levels(
            dists, jitter=1e-3))
        require_launches(f"{tag} gram_chol_dist_levels at m {ms}", launches,
                         plain, {"gram_chol_dist_levels": n8,
                                 "gram_chol_dist_levels_panel": 1})
        e8 = max(check_gram_dist(d, g, rtol, jitter=1e-3)[1]
                 for d, g in zip(dists, gd))
        e3 = []
        for m, form in zip(ms[1:], forms[1:]):
            dleaf = factor_leaves(3, m, dtype, gen)
            _, launches, plain = counted(lambda: leaf_factor(dleaf))
            require_launches(f"{tag} leaf_factor at n0 {m}", launches, plain,
                             {"leaf_factor": 1, "leaf_factor_panel":
                              int(form[1] == "panel")})
            e3.append(f"{m} {form[1]} {check_factor(dleaf, rtol)[0]:.2e}")
        e2, e9 = [], []
        for r in PANEL_R:
            a = torch.randn((9, r, r), generator=gen, **o)
            li = torch.linalg.inv(torch.linalg.cholesky(
                a @ a.mT / r + torch.eye(r, **o))).tril().contiguous()
            cross = [(rnd(3, m, 5), rnd(3, r, 5), li[3 * i:3 * i + 3])
                     for i, m in enumerate((48, 130, 512))]
            us, launches, plain = counted(lambda: bops.build_cross_levels(
                *zip(*cross)))
            require_launches(f"{tag} cross_solve_levels at r {r}", launches,
                             plain, {"cross_solve_levels": 1,
                                     "cross_solve_levels_panel": 1})
            e2.append(max(check_cross(c, rtol, got=u)[0]
                          for c, u in zip(cross, us)))
            cd = [((torch.cdist(p, z) ** 2).contiguous(), lv)
                  for p, z, lv in cross]
            us, launches, plain = counted(
                lambda: bops.build_cross_dist_levels(*zip(*cd)))
            require_launches(f"{tag} cross_solve_dist_levels at r {r}",
                             launches, plain,
                             {"cross_solve_dist_levels": 1,
                              "cross_solve_dist_levels_panel": 1})
            e9.append(max(check_cross_dist(d, lv, u, rtol)[0]
                          for (d, lv), u in zip(cd, us)))
        rows.append(
            f"{tag}: gram_chol_levels at m {ms} ({n1} launches, forms "
            f"{[f[0] for f in forms]}) max|d| {e1:.3e}; gram_chol_dist_levels "
            f"({n8} launches, forms {[f[2] for f in forms]}) max|d| "
            f"{e8:.3e}; leaf_factor L rel at n0 {', '.join(e3)}; "
            f"cross_solve_levels rel at r {PANEL_R} (m 48, 130, 512) "
            f"{[f'{e:.2e}' for e in e2]}, cross_solve_dist_levels "
            f"{[f'{e:.2e}' for e in e9]}")
    # an indefinite tile on the panel forms: NaN, no clamp
    pts = torch.randn((2, 256, 5), generator=gen, device=dev)
    pts[1, 200] = pts[1, 3]
    _, chol = bops.build_gram(pts, sigma=0.1, jitter=-1e-3)
    bad = torch.eye(300, device=dev).expand(2, 300, 300).clone()
    bad[1, 290, 290] = -1.0
    lo, _ = leaf_factor(bad)
    sync()
    require(bool(torch.isnan(chol[1]).any() and torch.isfinite(chol[0]).all()),
            "gram_chol's panel form (m 256): an indefinite block gives NaN")
    require(bool(torch.isnan(lo[1]).any() and torch.isfinite(lo[0]).all()),
            "leaf_factor's panel form (n0 300, its last panel): an "
            "indefinite leaf gives NaN")
    return rows


def check_panel_bf16_shapes(dev) -> str:
    """Phase 3r (f): the panel forms' bfloat16-data entries against their
    plain versions on the same bf16 data at phase 3r's ragged f32 shapes
    (the f32 gates), data views offset by one element: B1 grouped over m
    24 (its resident bf16 entry) and every PANEL_M, B8 the same on cached
    distances, B2 and B9 grouped over m 48, 130 and 512 at every PANEL_R;
    each launch counted on the form and entry its planner names."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.build_stage.ref import direct_dist

    gen = torch.Generator(device=dev).manual_seed(SEED + 33)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev) * math.sqrt(
            2 / shape[-1])

    ms = [24, *PANEL_M[torch.float32]]
    pts = [offset_view(bf16(rnd(2, m, 7))) for m in ms]
    grams, launches, plain = counted(lambda: bops.build_gram_levels(
        pts, jitter=1e-3))
    require_launches(f"bf16 gram_chol_levels at m {ms}", launches, plain,
                     {"gram_chol_levels": 2, "gram_chol_levels_panel": 1,
                      "gram_chol_levels_bf16": 2})
    e1 = max(check_build(p, True, 1e-4, jitter=1e-3, got=g)[0]
             for p, g in zip(pts, grams))
    dists = [offset_view(bf16(direct_dist(p.float(), p.float(), "l2")))
             for p in pts]
    gd, launches, plain = counted(lambda: bops.build_gram_dist_levels(
        dists, jitter=1e-3))
    require_launches(f"bf16 gram_chol_dist_levels at m {ms}", launches,
                     plain, {"gram_chol_dist_levels": 2,
                             "gram_chol_dist_levels_panel": 1,
                             "gram_chol_dist_levels_bf16": 2})
    e8 = max(check_gram_dist(d, g, 1e-4, jitter=1e-3)[0]
             for d, g in zip(dists, gd))
    e2, e9 = [], []
    for r in PANEL_R:
        a = torch.randn((9, r, r), generator=gen, device=dev)
        li = torch.linalg.inv(torch.linalg.cholesky(
            a @ a.mT / r + torch.eye(r, device=dev))).tril().contiguous()
        cross = [(offset_view(bf16(rnd(3, m, 7))),
                  offset_view(bf16(rnd(3, r, 7))), li[3 * i:3 * i + 3])
                 for i, m in enumerate((48, 130, 512))]
        us, launches, plain = counted(lambda: bops.build_cross_levels(
            *zip(*cross)))
        require_launches(f"bf16 cross_solve_levels at r {r}", launches,
                         plain, {"cross_solve_levels": 1,
                                 "cross_solve_levels_panel": 1,
                                 "cross_solve_levels_bf16": 1})
        e2.append(max(check_cross(c, None, got=u)[0]
                      for c, u in zip(cross, us)))
        cd = [(offset_view(bf16(direct_dist(p.float(), z.float(), "l2"))),
               lv) for p, z, lv in cross]
        us, launches, plain = counted(
            lambda: bops.build_cross_dist_levels(*zip(*cd)))
        require_launches(f"bf16 cross_solve_dist_levels at r {r}", launches,
                         plain, {"cross_solve_dist_levels": 1,
                                 "cross_solve_dist_levels_panel": 1,
                                 "cross_solve_dist_levels_bf16": 1})
        e9.append(max(check_cross_dist(d, lv, u, None)[0]
                      for (d, lv), u in zip(cd, us)))
    return (f"bf16 data (views one element in): gram_chol_levels at m {ms} "
            f"rel {e1:.2e}, gram_chol_dist_levels {e8:.2e} (1e-4); "
            f"cross_solve_levels rel at r {PANEL_R} (m 48, 130, 512) "
            f"{[f'{e:.2e}' for e in e2]}, cross_solve_dist_levels "
            f"{[f'{e:.2e}' for e in e9]} (componentwise)")


def check_grown_shapes(dev) -> list[str]:
    """Phase 3r (f): the forms the leaves of a model.update at leaf 256
    reach, at ragged shapes, f32 and f64, against their plain versions:
    B4's wide instance at n0 257, 300 and 512 (r 256 and 129, k 1, 7 and
    9, S = P and P/2); B13's panel form at (n0, k) (256, 9), (300, 12),
    (40, 300) and (1, 511), and an indefinite border giving NaN there; B5
    at n0 400 and 512 with 7 and 13 columns (in chunks where its planner
    cuts them: f64); each launch counted on its form."""
    from repro_torch.kernels.update_stage.ops import leaf_update, update_route

    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    rows = []
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        o = dict(dtype=dtype, device=dev)
        s = torch.finfo(dtype).bits // 8

        def rnd(*shape):
            return torch.randn(shape, generator=gen, **o)

        e4 = []
        for p, n0, r, k, sp in ((4, 257, 256, 7, 2), (3, 300, 129, 9, 3),
                                (2, 512, 256, 1, 1)):
            li = torch.linalg.inv(torch.linalg.cholesky(
                factor_leaves(p, n0, torch.float64, gen))).tril().to(dtype)
            args = (li.contiguous(), rnd(p, n0, r) / math.sqrt(n0),
                    rnd(sp, r, r) / r, rnd(p, n0, k))
            (rel, _), launches, _ = counted(lambda: check_leaf(
                "solve", args, rtol))
            require(launches["leaf_solve_wide"] == launches["leaf_solve"]
                    == 1, f"leaf_solve at n0 {n0} on its wide instance: "
                    f"{forms(launches, 'leaf_solve')}")
            e4.append(f"{n0} {rel:.2e}")
        e13 = []
        for p, n0, k in ((3, 256, 9), (2, 300, 12), (2, 40, 300),
                         (1, 1, 511)):
            a = torch.randn((p, n0 + k, n0 + k), generator=gen,
                            device=dev, dtype=torch.float64)
            full = a @ a.mT / (n0 + k) + torch.eye(n0 + k, device=dev,
                                                   dtype=torch.float64)
            lo = torch.linalg.cholesky(full[:, :n0, :n0])
            b13 = tuple(t.to(dtype).contiguous() for t in (
                lo, torch.linalg.inv(lo).tril(), full[:, n0:, :n0],
                full[:, n0:, n0:]))
            (rel_l, rel_i, _), launches, _ = counted(
                lambda: check_update_kernel(*b13, rtol))
            panel = launches["leaf_update_panel"]
            require(launches["leaf_update"] == 1 and panel == (
                update_route("3r", n0, k, s) == "panel"),
                f"leaf_update at n0 {n0}, k {k} on the form its planner "
                f"names: {forms(launches, 'leaf_update')}")
            e13.append(f"({n0}, {k}{' panel' if panel else ''}) "
                       f"{max(rel_l, rel_i):.2e}")
        bad = list(b13)
        bad[3] = bad[3] - 50 * torch.eye(bad[3].shape[-1], **o)
        lo_ext, _ = leaf_update(*bad)
        sync()
        require(bool(torch.isnan(lo_ext[:, 1:, 1:]).any()),
                "leaf_update's panel form: an indefinite border gives NaN")
        e5 = []
        for n0, k in ((400, 7), (512, 13)):
            args = (rnd(2, n0, n0), rnd(2, n0, RANK_R), rnd(2, n0, k))
            (rel, _), launches, _ = counted(lambda: check_leaf(
                "matvec", args, rtol))
            want = matvec_calls(n0, RANK_R, k, s)
            require(launches["leaf_matvec"] == want,
                    f"leaf_matvec at n0 {n0}, k {k}: {want} launches")
            e5.append(f"({n0}, {k}: {want} launch{'es' if want > 1 else ''})"
                      f" {rel:.2e}")
        rows.append(f"{str(dtype)[6:]}: leaf_solve (wide) rel at n0 "
                    f"{', '.join(e4)}; leaf_update new rows rel at (n0, k) "
                    f"{', '.join(e13)}, NaN on an indefinite border; "
                    f"leaf_matvec rel {', '.join(e5)} (within {rtol})")
    return rows


def rank256_kernels(model, rtol, what) -> tuple[dict, dict]:
    """Phase 3r (a): each kernel of a rank-256 krr.fit against its plain
    version at the fit's shapes: B1's Sigma (grouped, panel form) and
    Adiag, B2 (grouped, panel form; componentwise), B3 (panel form; L
    within rtol and the componentwise bounds), B4 and B5 at n0 = r = 256,
    B6.  Returns (max|d| by kernel, the launch arguments)."""
    from repro_torch.kernels.build_stage.ops import (build_cross_levels,
                                                     build_gram,
                                                     build_gram_levels)

    f = model.factors
    b = model.alpha.view(f.num_leaves, f.leaf_size, -1).contiguous()
    args = fit_launches(f, model.inverse, b)
    pts = [p for p, _ in args["gram"]]
    grams = build_gram_levels(pts[:-1], sigma=SIGMA, jitter=JITTER)
    errs = [check_build(p, True, rtol, got=g)
            for p, g in zip(pts[:-1], grams)]
    adiag = check_build(pts[-1], False, rtol, got=build_gram(
        pts[-1], sigma=SIGMA, jitter=JITTER, want_chol=False))
    us = build_cross_levels(*zip(*args["cross"]), sigma=SIGMA)
    cross = [check_cross(a, rtol, got=u) for a, u in zip(args["cross"], us)]
    fac = check_factor(args["dleaf"], rtol)
    res = {"gram_chol_sigma": max(e[1] for e in errs),
           "gram_chol_adiag": adiag[1],
           "cross_solve": max(e[1] for e in cross), "leaf_factor": fac[2]}
    for kind in ("solve", "matvec"):
        res[f"leaf_{kind}"] = check_leaf(kind, args[kind], rtol)[1]
    res["hck_leaf_project"] = check_project(f.u, model.plan.w_leaf)
    say(f"[3r rank256] {what} kernels against their plain versions at the "
        f"fit's shapes: gram_chol Sigma ({len(pts) - 1} levels of "
        f"{tuple(pts[0].shape[1:2])} tiles, panel form) rel "
        f"{max(e[0] for e in errs):.3e}, Adiag {tuple(pts[-1].shape)} rel "
        f"{adiag[0]:.3e}; cross_solve (U {tuple(args['cross'][0][0].shape)} "
        f"and {len(cross) - 1} W levels, panel form) rel "
        f"{max(e[0] for e in cross):.3e} (componentwise gate); leaf_factor "
        f"{tuple(args['dleaf'].shape)} (panel form) L rel {fac[0]:.3e}, "
        f"L^-1 rel {fac[1]:.3e}, backward {fac[3]:.3e}, inverse "
        f"{fac[4]:.3e}; leaf_solve, leaf_matvec, leaf_project max|d| "
        f"{res['leaf_solve']:.3e}, {res['leaf_matvec']:.3e}, "
        f"{res['hck_leaf_project']:.3e} (within {rtol}) ok")
    return res, args


def engine_gap(model, queries, chunk=4096) -> tuple[float, float]:
    """The fitted model's engine against the plain path on ``queries``:
    apply_plan's routing and sort with oos_local_walk's plain version in
    chunks.  (max|dz|, max|z_plain|)."""
    from repro_torch.core.partition import group_by_leaf, route
    from repro_torch.kernels.oos_stage.ref import oos_local_walk_ref

    f, plan = model.factors, model.plan
    got = model.engine(queries)
    xb = f.x_sorted.view(f.num_leaves, f.leaf_size, -1)
    err = scale = 0.0
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        leaf = route(f.tree, q)
        order, _, _ = group_by_leaf(leaf, f.num_leaves)
        ls = leaf[order].contiguous()
        z = torch.empty_like(got[s:s + chunk])
        z[order] = oos_local_walk_ref(
            xb, plan.w_leaf, f.landmarks[-1], plan.c_tilde,
            q[order].contiguous(), ls, (ls >> 1).contiguous(),
            name=model.kernel.name, sigma=model.kernel.sigma)
        err = max(err, float((got[s:s + chunk] - z).abs().max()))
        scale = max(scale, float(z.abs().max()))
    return err, scale


def fit_quality(model, fit, seed: int) -> dict:
    """A fit of phase 3's data (krr.fit's generator seeded ``seed``): its
    relative residual ||(K + lam I) alpha - y|| / ||y|| through the port's
    matvec on a float64 copy of its factors (the targets padded as krr.fit
    padded them: pad_points replayed on the same seed) and its test
    accuracy on the synthetic labels; printed, not gated (ROADMAP C12)."""
    from repro_torch.core import hmatrix
    from repro_torch.core.partition import pad_points

    f = model.factors
    gen = torch.Generator(device=fit["x"].device).manual_seed(seed)
    _, yp, _ = pad_points(fit["x"], fit["labels"], f.leaf_size, f.levels,
                          generator=gen)
    y = one_vs_all(yp, torch.float64)[f.tree.perm]
    a = model.alpha.double()
    r = y - hmatrix.matvec(to_f64(f), a) - LAM * a
    acc = model.predict_class(fit["xt"]) == fit["yt"]
    return {"resid": float(torch.linalg.vector_norm(r)
                           / torch.linalg.vector_norm(y)),
            "acc": float(acc.double().mean())}


def rank256_sweep(fit, dev) -> dict:
    """Phase 3r (d): one sigma row of the sweep at rank 256 on phase 3's
    data: build_sweep_plan, then sweep_factors counted (B8's Sigma and B9
    on their panel forms, B8's Adiag), each level of both grouped launches
    against the plain versions, and invert_multi over the 4 lambdas
    counted (B3's stacked launch on its panel form) with the stacked
    leaves against the plain factor."""
    from repro_torch.core import hmatrix
    from repro_torch.core.hck import build_sweep_plan, sweep_factors
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.core.partition import pad_points
    from repro_torch.kernels.build_stage import ops as bops

    ker = BaseKernel("gaussian", SIGMA, JITTER)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    xp, _, _ = pad_points(fit["x"], fit["labels"], RANK_R, LEVELS_R,
                          generator=gen)
    plan = build_sweep_plan(xp, levels=LEVELS_R, rank=RANK_R, generator=gen)
    fs, launches, plain = counted(lambda: sweep_factors(plan, ker))
    require_launches("sweep_factors at rank 256", launches, plain,
                     SWEEP_LAUNCHES_R)
    sl = launches
    a = sweep_launches(plan, fs)
    grams = bops.build_gram_dist_levels(a["sigma"], sigma=SIGMA,
                                        jitter=JITTER)
    e8 = max(check_gram_dist(d, g, 1e-4)[1] for d, g in zip(a["sigma"],
                                                           grams))
    us = bops.build_cross_dist_levels(*zip(*a["cross"]), sigma=SIGMA)
    e9 = [check_cross_dist(d, li, u, 1e-4) for (d, li), u in
          zip(a["cross"], us)]
    inv, launches, plain = counted(lambda: hmatrix.invert_multi(fs, LAMS))
    require_launches("invert_multi at rank 256", launches, plain,
                     {"leaf_factor": 1, "leaf_factor_panel": 1})
    schur = hmatrix._leaf_schur(fs)
    eye = torch.eye(RANK_R, device=dev)
    stacked = torch.cat([schur + lam * eye for lam in LAMS]).contiguous()
    del schur, inv
    fac = check_factor(stacked, 1e-4)
    say(f"[3r rank256] (d) one sigma row at rank 256: sweep_factors "
        f"launches {dict((k, v) for k, v in sl.items() if v)}; "
        f"gram_chol_dist_levels ({len(a['sigma'])} levels, panel form) "
        f"max|d| {e8:.3e} (1e-4 relative), cross_solve_dist_levels (U and "
        f"{len(a['cross']) - 1} W levels, panel form) rel "
        f"{max(e[0] for e in e9):.3e} (componentwise gate); invert_multi's "
        f"stacked leaf_factor {tuple(stacked.shape)} (panel form) L rel "
        f"{fac[0]:.3e}, backward {fac[3]:.3e}, inverse {fac[4]:.3e} ok")
    return {"plan": plan, "fs": fs, "launches": sl, "sweep_args": a,
            "stacked": stacked, "err8": e8,
            "err9": max(e[1] for e in e9), "err3s": fac[2]}


# ---------------------------------------------------------------------------
# Phase 3r (g)-(i): the rank-256 lifecycle
# ---------------------------------------------------------------------------

# (h): benchmarks/bench_update.py --full (n 65,536, d 5, rank 256, float64,
# gaussian sigma 2 with jitter 1e-8, lambda 1e-2, a 1% insert, the
# predictions of 256 queries within its --parity-tol 1e-6 of the
# refit_frozen oracle); a 2% insert beside it takes leaves to k > 8, past
# the resident B13's shared memory in float64
UPD64_N, UPD64_D, UPD64_SIGMA, UPD64_JITTER = 65_536, 5, 2.0, 1e-8
UPD64_LAM, UPD64_FRACS, UPD64_PARITY = 1e-2, (0.01, 0.02), 1e-6


def forms(launches: dict, *names) -> dict:
    """The launches of ``names`` and of their forms (``<name>_panel``,
    ``leaf_solve_wide``, ...) that ran, for the log."""
    return {k: v for k, v in launches.items() if v and any(
        k == n or k.startswith(n + "_") for n in names)}


def matvec_calls(n0: int, r: int, k: int, itemsize: int) -> int:
    """B5's launches for one leaf_matvec call of k columns at (n0, r): one
    where its plan fits, else one a chunk of matvec_max_rhs columns."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.hck_leaf.ops import matvec_max_rhs, matvec_plan

    if k == 1 or matvec_plan(n0, r, k, itemsize)["smem"] <= _build.SMEM_MAX:
        return 1
    return -(-k // matvec_max_rhs(n0, r, itemsize))


def update_expected(refresh: str, r: int, cols: int, itemsize: int):
    """The launches of one model.update round (phase 8c's structure), as a
    function of the updated model and its record: B2's projection of the
    appended rows, B13 (refresh "inverse") or B3 ("exact"), three B4 and
    five B5 launches of the structured re-solve (``cols`` targets) and one
    B6, each on the form its planner names for the grown leaves."""
    from repro_torch.kernels.build_stage.ops import cross_route
    from repro_torch.kernels.hck_leaf.ops import (SOLVE_RESIDENT_ROWS,
                                                  factor_route, factor_smem)
    from repro_torch.kernels.update_stage.ops import update_route

    def expected(model, info):
        n0, k = model.factors.leaf_size, info.record.k
        want = {"cross_solve": 1, "leaf_solve": 3,
                "leaf_matvec": 5 * matvec_calls(n0, r, cols, itemsize),
                "hck_leaf_project": 1,
                "cross_solve_panel": int(cross_route("3r", r, itemsize)
                                         == "panel"),
                "leaf_solve_wide": 3 * (n0 > SOLVE_RESIDENT_ROWS)}
        if refresh == "inverse":
            want.update(leaf_update=1, leaf_update_panel=int(update_route(
                "3r", n0 - k, k, itemsize) == "panel"))
        else:
            want.update(leaf_factor=1, leaf_factor_panel=int(factor_route(
                "3r", n0, itemsize, factor_smem) == "panel"))
        return want

    return expected


def update_oracle(model, queries):
    """bench_update.py's parity reference: the leaf stages rebuilt from
    scratch on the model's own union (refit_frozen), the targets it fitted
    (K alpha + lam alpha) solved directly, a fresh serving plan; its
    predictions of ``queries``."""
    from repro_torch.core import hmatrix, krr, oos, update

    cfg, lam = model.solve_config, model.lam
    f_ref = update.refit_frozen(model.factors, model.kernel, cfg,
                                jitter_rows=model.base_leaf_size)
    ys = hmatrix.matvec(model.factors, model.alpha, cfg) + lam * model.alpha
    alpha = hmatrix.solve(f_ref, ys, ridge=lam, config=cfg)
    oracle = krr.HCKRegressor(
        model.kernel, f_ref, oos.prepare(f_ref, alpha, cfg), alpha,
        model.classes, squeeze=model.squeeze, solve_config=cfg, lam=lam,
        base_leaf_size=model.base_leaf_size)
    return oracle.predict(queries)


def rank256_update(model, fit, dev) -> dict:
    """Phase 3r (g): two model.update rounds of UPDATE_Q arrivals (phase
    8c's at rank 128) on the rank-256 fit (f32, leaves of 256): refresh
    "inverse" (B13 borders the cached leaf factors), then "exact" from it
    (B3's panel form refactors the grown leaves); each round counted by
    form (update_expected); round 1's predictions on all test queries
    against the refit_frozen oracle within the f32 floor, as phase 8c holds
    its rounds; B13, B4 and B5 against their plain versions at round 1's
    shapes."""
    from repro_torch.core import hmatrix

    xt = fit["xt"]
    x1, y1 = fresh_points(UPDATE_Q, SEED + 50, dev)
    x2, y2 = fresh_points(UPDATE_Q, SEED + 51, dev)
    m1, info1, l1, t1 = update_round(
        model, x1, y1, update_expected("inverse", RANK_R, N_CLASSES, 4),
        "rank-256 update round 1 (inverse)")
    s1 = matvec_shapes()
    m2, info2, l2, t2 = update_round(
        m1, x2, y2, update_expected("exact", RANK_R, N_CLASSES, 4),
        "rank-256 update round 2 (exact)", refresh="exact")
    n1, n2 = m1.factors.leaf_size, m2.factors.leaf_size
    for tag, info in (("1", info1), ("2", info2)):
        require(info.converged and math.isfinite(info.residual),
                f"rank-256 round {tag} solved: {info}")
    del m2
    pred = m1.predict(xt)
    gap = rel_max(pred, update_oracle(m1, xt))
    floor = res_floor(model, dev)
    require(bool(torch.isfinite(pred).all()) and gap <= floor,
            f"rank-256 round 1 vs the refit_frozen oracle: rel {gap:.3e} <= "
            f"f32 floor {floor:.3e}")
    f1, ys1, _ = replay_insert(model, x1, y1)
    require(torch.equal(f1.u, m1.factors.u), "rank-256 round 1 replayed")
    bb, cc = hmatrix.extension_blocks(f1, n0_base=RANK_R, ridge=LAM)
    b13 = tuple(t.contiguous() for t in (model.leaf_lo, model.inverse.linv,
                                         bb, cc))
    rel_l, rel_i, e13 = check_update_kernel(*b13, 1e-4)
    inv = m1.inverse
    b = ys1.view(f1.num_leaves, n1, -1).contiguous()
    b4 = tuple(t.contiguous() for t in (inv.linv, inv.u, inv.sigma[-1], b))
    rel4, e4 = check_leaf("solve", b4, 1e-4)
    b5 = (f1.adiag, f1.u, b)
    rel5, e5 = check_leaf("matvec", b5, 1e-4)
    names = ("cross_solve", "leaf_update", "leaf_factor", "leaf_solve",
             "leaf_matvec")
    say(f"[3r rank256] (g) model.update at rank and leaf 256 (f32, "
        f"{UPDATE_Q} arrivals a round): leaves 256 -> {n1} (k "
        f"{info1.record.k}, refresh 'inverse', {t1:.3f} s, residual "
        f"{info1.residual:.3e}) -> {n2} (k {info2.record.k}, 'exact', "
        f"{t2:.3f} s, residual {info2.residual:.3e}); launches by form "
        f"{forms(l1, *names)} (B5 by shape {s1}), {forms(l2, *names)} "
        f"(exact); no plain version")
    say(f"[3r rank256] (g) round 1 vs refit_frozen + solve + prepare on all "
        f"{N_TEST} test queries: rel {gap:.3e} <= f32 floor {floor:.3e}; at "
        f"round 1's shapes against the plain versions: leaf_update "
        f"{tuple(b13[0].shape)} + k {bb.shape[1]} new rows rel L "
        f"{rel_l:.3e}, L^-1 {rel_i:.3e}; leaf_solve n0 {n1} rel {rel4:.3e}; "
        f"leaf_matvec rel {rel5:.3e} (1e-4) ok")
    return {"launches": [l1, l2], "b13": b13, "b4": b4, "b5": b5,
            "err": {"leaf_update": e13, "leaf_solve": e4, "leaf_matvec": e5},
            "k": (info1.record.k, info2.record.k), "walls": (t1, t2),
            "gap": gap, "floor": floor}


def rank256_update_f64(dev) -> dict:
    """Phase 3r (h): bench_update.py --full's shape on the card (UPD64_*):
    a float64 fit of 65,536 points at rank and leaf 256, then from it a 1%
    and a 2% insert (refresh "inverse"), each counted by form, its
    predictions of 256 queries within 1e-6 of the refit_frozen oracle (the
    bench's --parity-tol); B13 at the 2% insert's shape (k > 8: its panel
    form), B4 (wide) and B5 against their plain versions in f64."""
    from repro_torch.core import hmatrix, krr
    from repro_torch.core.kernels_fn import BaseKernel

    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    o = dict(generator=gen, device=dev, dtype=torch.float64)

    def target(x):
        return torch.sin(x[:, 0]) + 0.25 * torch.cos(2.0 * x[:, 1])

    x = torch.randn((UPD64_N, UPD64_D), **o)
    queries = torch.randn((256, UPD64_D), **o)
    model = krr.fit(x, target(x), kernel=BaseKernel(
        "gaussian", UPD64_SIGMA, UPD64_JITTER), lam=UPD64_LAM, rank=RANK_R,
        generator=torch.Generator(device=dev).manual_seed(SEED + 53))
    require(model.factors.leaf_size == RANK_R, "the f64 fit's leaves of 256")
    rounds = []
    for frac in UPD64_FRACS:
        xn = torch.randn((round(UPD64_N * frac), UPD64_D), **o)
        m, info, launches, wall = update_round(
            model, xn, target(xn), update_expected("inverse", RANK_R, 1, 8),
            f"f64 rank-256 {frac:.0%} insert")
        err = float((m.predict(queries) - update_oracle(m, queries))
                    .abs().max())
        require(info.converged and err <= UPD64_PARITY,
                f"f64 {frac:.0%} insert vs the refit_frozen oracle: max|dz| "
                f"{err:.3e} <= {UPD64_PARITY}")
        rounds.append({"frac": frac, "k": info.record.k, "err": err,
                       "wall": wall, "launches": launches})
        say(f"[3r rank256] (h) bench_update --full's shape (f64, n "
            f"{UPD64_N}, rank 256): {frac:.0%} insert ({xn.shape[0]} "
            f"points) k {info.record.k}, leaves 256 -> "
            f"{m.factors.leaf_size}, {wall:.3f} s; launches by form "
            f"{forms(launches, 'cross_solve', 'leaf_update', 'leaf_solve')}"
            f", {forms(launches, 'leaf_matvec', 'hck_leaf_project')}; "
            f"predictions vs the refit_frozen oracle max|dz| {err:.3e} <= "
            f"{UPD64_PARITY} ok")
    f1, ys, _ = replay_insert(model, xn, target(xn))
    bb, cc = hmatrix.extension_blocks(f1, n0_base=RANK_R, ridge=UPD64_LAM)
    b13 = tuple(t.contiguous() for t in (model.leaf_lo, model.inverse.linv,
                                         bb, cc))
    (rel_l, rel_i, e13), l13, _ = counted(
        lambda: check_update_kernel(*b13, 1e-10))
    require(bb.shape[1] > 8 and l13["leaf_update_panel"] == 1,
            f"B13 in f64 at k {bb.shape[1]} > 8 on its panel form: {l13}")
    inv = m.inverse
    b = ys.view(f1.num_leaves, f1.leaf_size, -1).contiguous()
    b4 = tuple(t.contiguous() for t in (inv.linv, inv.u, inv.sigma[-1], b))
    rel4, e4 = check_leaf("solve", b4, 1e-10)
    rel5, e5 = check_leaf("matvec", (f1.adiag, f1.u, b), 1e-10)
    say(f"[3r rank256] (h) f64 at the 2% insert's shapes against the plain "
        f"versions: leaf_update (panel form) {tuple(b13[0].shape)} + k "
        f"{bb.shape[1]}: new rows rel L {rel_l:.3e}, L^-1 {rel_i:.3e}; "
        f"leaf_solve (wide) n0 {f1.leaf_size} rel {rel4:.3e}; leaf_matvec "
        f"rel {rel5:.3e} (1e-10) ok")
    return {"rounds": rounds, "b13": b13, "b4": b4,
            "err": {"leaf_update": e13, "leaf_solve": e4,
                    "leaf_matvec": e5}}


def rank256_policy_gap(dev) -> dict:
    """Phase 3r (i): phase 8d (a)'s problem (PREC_*) at rank and leaf 256
    (n 4,096: 4 levels) built under the bf16 policy (on the panel forms'
    bfloat16-data entries, counted) against the f64 build on one tree and
    one landmark set: the Gram-family factors, a matvec and the f64
    model's predictions under the policy within PREC_GATES["bf16"]."""
    from repro_torch.core import hck, oos
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.registry import SolveConfig

    gen = torch.Generator(device=dev).manual_seed(SEED + 54)
    o = dict(generator=gen, device=dev, dtype=torch.float64)
    x, b = torch.randn((PREC_N, PREC_D), **o), torch.randn((PREC_N, 2), **o)
    w, q = torch.randn((PREC_N, 2), **o), torch.randn((1024, PREC_D), **o)
    ker = BaseKernel("gaussian", PREC_SIGMA, PREC_JITTER)
    levels = (PREC_N // RANK_R).bit_length() - 1

    def build(prec):
        return hck.build_hck(
            x, levels=levels, rank=RANK_R, kernel=ker,
            config=SolveConfig(precision=prec),
            generator=torch.Generator(device=dev).manual_seed(SEED + 55))

    ref = build(None)
    fb, launches, _ = counted(lambda: build("bf16"))
    require(launches["gram_chol_levels_panel"] == launches[
        "gram_chol_levels_bf16"] == launches["cross_solve_levels_panel"]
        == launches["cross_solve_levels_bf16"] == 1,
        f"the bf16 build at rank 256 on the panel bf16 entries: {launches}")
    ftol, otol = PREC_GATES["bf16"]
    fe, mv, pe = policy_gap(fb, ref, oos.prepare(ref, w), q, ker, b, "bf16")
    say(f"[3r rank256] (i) the bf16 policy at rank and leaf 256 (n {PREC_N}, "
        f"d {PREC_D}, {levels} levels) against the f64 build: Gram-family "
        f"factors {fe:.3e} (gate {ftol:g}), matvec {mv:.3e}, predictions "
        f"{pe:.3e} (gate {otol:g}) ok")
    return {"factors": fe, "matvec": mv, "predictions": pe}


def rank256_bf16(fit, sweep, dev) -> dict:
    """Phase 3r (i): the bf16 policy at rank 256 (leaves of 256) at
    covtype width and the reference launcher's convention (BF16_JITTER,
    BF16_LAM): krr.fit counted (B1's Sigma and B2 on their panel forms'
    bfloat16-data entries, B1's Adiag on its resident one), each bf16
    launch against its plain version on the same bf16 data at the f32
    gates; one bf16 sigma row of sweep_factors on (d)'s plan counted (B8's
    Sigma and B9 on their panel bf16 entries), B8 and B9 against plain;
    the policy's gaps to the f64 build (rank256_policy_gap); launch.train
    --precision bf16 --rank 256."""
    from repro_torch.core import hck, krr
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.registry import SolveConfig

    ker = BaseKernel("gaussian", SIGMA, BF16_JITTER)
    cfg = SolveConfig(precision="bf16")
    bf16_fit = {"gram_chol_bf16": 1, "gram_chol_levels_bf16": 1,
                "cross_solve_levels_bf16": 1}
    m16, launches, plain = counted(lambda: krr.fit(
        fit["x"], fit["labels"], kernel=ker, lam=BF16_LAM, rank=RANK_R,
        classification=True, solve_config=cfg,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1)))
    require_launches("the bf16 krr.fit at rank 256", launches, plain,
                     dict(FIT_LAUNCHES_R, **bf16_fit))
    fl = launches
    f16 = m16.factors
    require(f16.leaf_size == RANK_R and f16.u.dtype == torch.float32
            and bool(torch.isfinite(m16.alpha).all()),
            "the bf16 fit at rank 256: leaves of 256, finite float32 alpha")
    args = fit_launches(f16, m16.inverse, m16.alpha.view(
        f16.num_leaves, RANK_R, N_CLASSES))
    del m16, f16
    gram16, cross16 = bf16_fit_args(args)
    pts = [p for p, _ in gram16]
    grams = bops.build_gram_levels(pts[:-1], sigma=SIGMA, jitter=BF16_JITTER)
    grams.append(bops.build_gram(pts[-1], sigma=SIGMA, jitter=BF16_JITTER,
                                 want_chol=False))
    e1 = [check_build(p, want, 1e-4, jitter=BF16_JITTER, got=g)
          for (p, want), g in zip(gram16, grams)]
    del grams
    us = bops.build_cross_levels(*zip(*cross16), sigma=SIGMA)
    e2 = [check_cross(a, None, got=u) for a, u in zip(cross16, us)]
    del us
    say(f"[3r rank256] (i) bf16 krr.fit at rank 256 (sigma {SIGMA}, lam "
        f"{BF16_LAM:g}, jitter {BF16_JITTER:g}): launches "
        f"{ {k: v for k, v in fl.items() if v} } (exact); against the plain "
        f"versions on the same bf16 data: gram_chol_levels_panel_bf16 "
        f"({len(pts) - 1} Sigma levels) rel {max(e[0] for e in e1[:-1]):.3e}"
        f", the Adiag (resident bf16 entry) rel {e1[-1][0]:.3e} (1e-4); "
        f"cross_solve_levels_panel_bf16 (U and {len(cross16) - 1} W levels) "
        f"rel {max(e[0] for e in e2):.3e} (componentwise gate) ok")
    f16s, launches, plain = counted(lambda: hck.sweep_factors(
        sweep["plan"], ker, cfg))
    require_launches("one bf16 sigma row at rank 256", launches, plain,
                     dict(SWEEP_LAUNCHES_R, gram_chol_dist_levels_bf16=1,
                          gram_chol_dist_bf16=1,
                          cross_solve_dist_levels_bf16=1))
    sl = launches
    a = sweep_launches(sweep["plan"], f16s)
    del f16s
    sig16 = [bf16(d) for d in a["sigma"]]
    cd16 = [(bf16(d), li) for d, li in a["cross"]]
    e8 = [check_gram_dist(d, g, 1e-4, jitter=BF16_JITTER) for d, g in zip(
        sig16, bops.build_gram_dist_levels(sig16, sigma=SIGMA,
                                           jitter=BF16_JITTER))]
    e9 = [check_cross_dist(d, li, u, None) for (d, li), u in zip(
        cd16, bops.build_cross_dist_levels(*zip(*cd16), sigma=SIGMA))]
    say(f"[3r rank256] (i) one bf16 sigma row at rank 256: launches "
        f"{ {k: v for k, v in sl.items() if v} } (exact); "
        f"gram_chol_dist_levels_panel_bf16 ({len(sig16)} Sigma levels) rel "
        f"{max(e[0] for e in e8):.3e} (1e-4), "
        f"cross_solve_dist_levels_panel_bf16 (U and {len(cd16) - 1} W "
        f"levels) rel {max(e[0] for e in e9):.3e} (componentwise) ok")
    gaps = rank256_policy_gap(dev)
    num = r"[0-9.]+"
    launcher_mode(
        ["--task", "krr", "--n", str(LAUNCH_N), "--d", str(D), "--rank",
         str(RANK_R), "--precision", "bf16"],
        dict(FIT_LAUNCHES_R, **bf16_fit, oos_contract=1, oos_contract_pair=1,
             oos_contract_bf16=1),
        [rf"krr n={LAUNCH_N} d={D} rank={RANK_R} backend=auto \(in-memory\): "
         rf"fit {num} s \([0-9,]+ points/s\), train rel-err {num}"],
        tag="[3r rank256] (i)")
    return {"launches": fl, "sweep_launches": sl, "gram16": pts[:-1],
            "cross16": cross16, "sig16": sig16, "cd16": cd16,
            "err": {"gram_chol": max(e[1] for e in e1[:-1]),
                    "cross_solve": max(e[1] for e in e2),
                    "gram_chol_dist": max(e[1] for e in e8),
                    "cross_solve_dist": max(e[1] for e in e9)},
            "gaps": gaps}


def phase_rank256(fit, dev) -> dict:
    """Phase 3r: rank 256, the reference benches' default, on phase 3's
    data at covtype width: (a) krr.fit at rank 256, leaf 256 (the counts
    set to 0 just before and read just after: B1's Sigma, B2 and B3 on
    their panel forms), each kernel against its plain version at the fit's
    shapes; (b) its residual and test accuracy beside phase 3's rank 128
    (printed); (c) serving through its engine (one B7 launch a bucket,
    counted) against the plain path on all test queries; (d) one sigma row
    of the sweep (B8, B9 and B3's stacked launch on their panel forms)
    against the plain versions; (e) the f64 fit at rank and leaf 256 (8,192
    points) with its kernels against the plain versions; (f) every panel
    kernel at ragged shapes (check_panel_shapes); the lifecycle at rank
    256: (g) two model.update rounds on (a)'s model (rank256_update), (h)
    bench_update.py --full's f64 shape (rank256_update_f64), (i) the bf16
    policy (rank256_bf16)."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel

    t0 = time.perf_counter()
    x, labels, xt = fit["x"], fit["labels"], fit["xt"]
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    opts = dict(kernel=ker, lam=LAM, rank=RANK_R, classification=True)

    def fit_r(xx, ll):
        return krr.fit(xx, ll, generator=torch.Generator(
            device=dev).manual_seed(SEED + 1), **opts)

    sync()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model, launches, plain = counted(lambda: fit_r(x, labels))
    t_fit = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    require_launches("krr.fit at rank 256", launches, plain, FIT_LAUNCHES_R)
    f = model.factors
    require(f.levels == LEVELS_R and f.leaf_size == RANK_R
            and f.rank == RANK_R and bool(torch.isfinite(model.alpha).all()),
            f"the rank-256 fit: {f.levels} levels of leaves {f.leaf_size}, "
            f"rank {f.rank}, alpha finite")
    say(f"[3r rank256] (a) krr.fit n={N_TRAIN} -> {f.n} d={D} "
        f"levels={f.levels} leaf={f.leaf_size} r={f.rank}: {t_fit:.3f} s "
        f"(first call), peak device memory {peak:.2f} GiB; launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    res, args = rank256_kernels(model, 1e-4, "(a) f32")
    fl = launches
    q = fit_quality(model, fit, SEED + 1)
    q128 = fit_quality(fit["model"], fit, SEED + 1)
    say(f"[3r rank256] (b) relative residual ||(K + lam I) alpha - y|| / "
        f"||y|| (f64 copy of the factors): rank 256 {q['resid']:.3e}, rank "
        f"128 (phase 3) {q128['resid']:.3e}; test accuracy on the synthetic "
        f"labels: rank 256 {q['acc']:.4f}, rank 128 {q128['acc']:.4f} "
        f"(printed, not gated: ROADMAP C12)")
    _, _, pair = bucket_inputs(f, model.plan, xt[:4096])
    res["oos_local_walk"] = check_contract(pair, name="gaussian", rtol=1e-4,
                                           pair=True)[0]
    z, launches, plain = counted(lambda: model.engine(xt))
    calls = launches["oos_contract"]
    require(calls > 0 and launches["oos_contract_pair"] == calls and not any(
        v for k, v in launches.items()
        if k not in ("oos_contract", "oos_contract_pair"))
        and not any(plain.values()),
        f"serving at rank 256: one B7 launch a bucket and nothing else: "
        f"{launches}, plain {plain}")
    err, scale = engine_gap(model, xt)
    require(bool(torch.isfinite(z).all()) and err <= 1e-4 * scale,
            f"rank-256 engine vs the plain path: max|dz| {err:.3e} <= 1e-4 "
            f"* {scale:.3e}")
    say(f"[3r rank256] (c) serving all {N_TEST} test queries through the "
        f"engine: {calls} B7 launches (one a bucket), max|dz| {err:.3e} of "
        f"max|z| {scale:.3e} against the plain path (1e-4 relative); one "
        f"4096-query bucket's oos_local_walk max|dz| "
        f"{res['oos_local_walk']:.3e} ok")
    sweep = rank256_sweep(fit, dev)
    n64 = RANK_R << LEVELS_R64
    m64, launches, plain = counted(lambda: fit_r(x[:n64].double(),
                                                 labels[:n64]))
    require_launches("f64 krr.fit at rank 256", launches, plain,
                     FIT_LAUNCHES_R)
    require(m64.factors.levels == LEVELS_R64, "the f64 fit's depth")
    rank256_kernels(m64, 1e-10, f"(e) f64 (n {n64}, {LEVELS_R64} levels)")
    del m64
    for row in (*check_panel_shapes(dev), check_panel_bf16_shapes(dev),
                *check_grown_shapes(dev)):
        say(f"[3r rank256] (f) ragged shapes, {row} ok")
    upd = rank256_update(model, fit, dev)
    upd64 = rank256_update_f64(dev)
    b16 = rank256_bf16(fit, sweep, dev)
    t_all = time.perf_counter() - t0
    say(f"[3r rank256] phase done in {t_all:.1f} s")
    return {"model": model, "args": args, "launches": fl, "res": res,
            "sweep": sweep, "quality": q, "quality128": q128,
            "t_fit": t_fit, "t": t_all, "update": upd, "update64": upd64,
            "bf16": b16}


def panel_timing(r3) -> list[dict]:
    """Phase 9, rank 256: each panel kernel at the covtype shapes of phase
    3r in turns with its plain version (kernel, plain, plain, kernel):
    B1's Sigma launch (11 levels) and B2's grouped launch of the fit, B3
    at the fit's leaves and stacked at G = 4 (beside the chain cholesky +
    solve_triangular), B8's Sigma launch and B9's of the sweep's sigma
    row, each beside its bound (the *_cost functions; B2's and B9's the
    tensor-core route's) and its launches on the counted paths."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.build_stage import ref as bref
    from repro_torch.kernels.hck_leaf import ops as lops
    from repro_torch.kernels.hck_leaf import ref as lref

    args, sw, fl = r3["args"], r3["sweep"], r3["launches"]
    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    opts = dict(sigma=SIGMA, jitter=JITTER)
    pts = [p for p, _ in args["gram"]][:-1]
    cross, dleaf = args["cross"], args["dleaf"]
    sig, cd = sw["sweep_args"]["sigma"], sw["sweep_args"]["cross"]
    stacked, sl = sw["stacked"], sw["launches"]

    def turns(new, old, reps):
        ms, plain, t = in_turns(new, old, reps)
        return ms, plain, {"kernel": [t[0], t[3]], "plain": [t[1], t[2]]}

    def total(costs):
        return sum(c[0] for c in costs), sum(c[1] for c in costs)

    records = []
    ms, plain, t = turns(lambda: bops.build_gram_levels(pts, **opts),
                         lambda: bref.build_gram_levels_ref(pts, **opts), 3)
    records.append(kernel_record(
        "gram_chol (panel form)", src + "build_stage_panel.cu",
        tpu + "build_stage/build_stage.py:124",
        fl["gram_chol_levels_panel"], r3["res"]["gram_chol_sigma"], ms,
        plain, bound_ms(*total([gram_cost(p, True) for p in pts])),
        unit=f"rank 256: one grouped launch ({len(pts)} Sigma levels of "
             f"{RANK_R}^2 with their factors)", turns_ms=t))
    ms, plain, t = turns(
        lambda: bops.build_cross_levels(*zip(*cross), sigma=SIGMA),
        lambda: bref.build_cross_levels_ref(*zip(*cross), sigma=SIGMA), 3)
    nbytes = sum(cross_cost(*a)[0] for a in cross)
    records.append(kernel_record(
        "cross_solve (panel form)", src + "build_stage_panel.cu",
        tpu + "build_stage/build_stage.py:157",
        fl["cross_solve_levels_panel"], r3["res"]["cross_solve"], ms, plain,
        cross_tc_bound(nbytes, [a[0].shape[:2] + a[1].shape[1:2]
                                for a in cross]),
        unit=f"rank 256: one grouped launch (U and {len(cross) - 1} W "
             "levels)", turns_ms=t,
        bound_f32_ms=bound_ms(*total([cross_cost(*a) for a in cross]))[0],
        direct_sum_floor_ms=sum(direct_sum_floor_ms(
            a[0].shape[0] * a[0].shape[1] * a[1].shape[1], a[0].shape[2])
            for a in cross)))
    ms, plain, t = turns(lambda: lops.leaf_factor(dleaf),
                         lambda: lref.hck_leaf_factor_ref(dleaf), 3)
    s_ms, s_plain, s_t = turns(lambda: lops.leaf_factor(stacked),
                               lambda: lref.hck_leaf_factor_ref(stacked), 2)
    records.append(kernel_record(
        "leaf_factor (panel form)", src + "leaf_factor_panel.cu",
        tpu + "hck_leaf/hck_leaf.py:194", fl["leaf_factor_panel"]
        + sl.get("leaf_factor_panel", 0), r3["res"]["leaf_factor"], ms,
        plain, bound_ms(*factor_cost(dleaf)),
        unit=f"rank 256: one launch {tuple(dleaf.shape)}", turns_ms=t,
        library_chain_ms=time_ms(lambda: factor_chain(dleaf), 3),
        library_chain="torch.linalg.cholesky + solve_triangular",
        stacked={"shape": list(stacked.shape), "ms": s_ms,
                 "plain_ms": s_plain, "turns_ms": s_t,
                 "bound_ms": bound_ms(*factor_cost(stacked))[0],
                 "chain_ms": time_ms(lambda: factor_chain(stacked), 2),
                 "launches_sweep_row": 1}))
    ms, plain, t = turns(
        lambda: bops.build_gram_dist_levels(sig, **opts),
        lambda: bref.build_gram_dist_levels_ref(sig, **opts), 3)
    records.append(kernel_record(
        "gram_chol_dist (panel form)", src + "build_dist_panel.cu",
        tpu + "build_stage/build_stage.py:215",
        sl["gram_chol_dist_levels_panel"], sw["err8"], ms, plain,
        bound_ms(*total([gram_dist_cost(d, True) for d in sig])),
        unit=f"rank 256, one sigma: one grouped launch ({len(sig)} Sigma "
             "levels)", turns_ms=t))
    ms, plain, t = turns(
        lambda: bops.build_cross_dist_levels(*zip(*cd), sigma=SIGMA),
        lambda: bref.build_cross_dist_levels_ref(*zip(*cd), sigma=SIGMA), 3)
    records.append(kernel_record(
        "cross_solve_dist (panel form)", src + "build_dist_panel.cu",
        tpu + "build_stage/build_stage.py:254",
        sl["cross_solve_dist_levels_panel"], sw["err9"], ms, plain,
        cross_dist_tc_bound(cd),
        unit=f"rank 256, one sigma: one grouped launch (U and "
             f"{len(cd) - 1} W levels)", turns_ms=t,
        bound_f32_ms=bound_ms(*total([cross_dist_cost(d, li)
                                      for d, li in cd]))[0]))
    for rec in records:
        extra = ""
        if "library_chain_ms" in rec:
            st = rec["stacked"]
            extra = (f", chain {rec['library_chain']} "
                     f"{rec['library_chain_ms']:.4f} ms; stacked "
                     f"{tuple(st['shape'])}: kernel {st['ms']:.4f} ms, plain "
                     f"{st['plain_ms']:.4f} ms, chain {st['chain_ms']:.4f} "
                     f"ms, bound {st['bound_ms']:.4f} ms (turns "
                     f"{st['turns_ms']})")
        if "bound_f32_ms" in rec:
            extra += f", f32 CUDA-core bound {rec['bound_f32_ms']:.4f} ms"
        if "direct_sum_floor_ms" in rec:
            extra += (f", direct-sum issue floor "
                      f"{rec['direct_sum_floor_ms']:.4f} ms")
        say(f"[9 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms (turns "
            f"{rec['turns_ms']}){extra}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), launches {rec['launches']}")
    return records


def lifecycle256_timing(r3) -> list[dict]:
    """Phase 9, the rank-256 lifecycle's new forms at phase 3r's shapes,
    each in turns with its plain version (kernel, plain, plain, kernel),
    beside its bound (the *_cost functions) and its launches on 3r's
    counted paths: the panel forms' bfloat16-data entries of B1 and B2
    (the bf16 fit's Sigma and cross launches) and of B8 and B9 (the bf16
    sigma row's), each with its float32 entry on the same data cast to
    float32 timed beside; B4's wide instance at (g)'s round-1 shape (f32)
    and at (h)'s 2% shape (f64), by device time, the resident instance at
    the rank-256 fit's shape beside; B13's panel form at (h)'s
    2% shape (f64, device time), (g)'s round-1 launch on the resident form
    beside; B5 at (g)'s round-1 grown leaves, and in chunks at (h)'s model
    width with n0 384 (the leaves RebuildPolicy's default growth of 0.5
    reaches) and 7 columns in f64."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.build_stage import ref as bref
    from repro_torch.kernels.hck_leaf import ops as lops
    from repro_torch.kernels.hck_leaf import ref as lref
    from repro_torch.kernels.update_stage.ops import leaf_update
    from repro_torch.kernels.update_stage.ref import leaf_update_ref

    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    g, h, i16 = r3["update"], r3["update64"], r3["bf16"]
    fl, sl = i16["launches"], i16["sweep_launches"]
    ups = g["launches"] + [rd["launches"] for rd in h["rounds"]]
    opts = dict(sigma=SIGMA, jitter=BF16_JITTER)

    def turns(new, old, reps, device=False):
        ms, plain, t = in_turns(new, old, reps, device)
        return ms, plain, {"kernel": [t[0], t[3]], "plain": [t[1], t[2]]}

    def f32(t):
        return t.float() if t.dtype == torch.bfloat16 else t

    records = []
    pts, cross = i16["gram16"], i16["cross16"]
    ms, plain, t = turns(lambda: bops.build_gram_levels(pts, **opts),
                         lambda: bref.build_gram_levels_ref(pts, **opts), 3)
    p32 = [f32(p) for p in pts]
    costs = [gram_cost(p, True) for p in pts]
    records.append(kernel_record(
        "gram_chol (panel form, bf16 data)", src + "build_stage_panel.cu",
        tpu + "build_stage/build_stage.py:124", fl["gram_chol_levels_panel"],
        i16["err"]["gram_chol"], ms, plain,
        bound_ms(sum(c[0] for c in costs), sum(c[1] for c in costs)),
        unit=f"rank 256, bf16 fit: one grouped launch ({len(pts)} Sigma "
             f"levels of {RANK_R}^2 with their factors)", turns_ms=t,
        f32_entry_ms=time_ms(lambda: bops.build_gram_levels(p32, **opts), 3)))
    c32 = [tuple(f32(x) for x in a) for a in cross]
    ms, plain, t = turns(
        lambda: bops.build_cross_levels(*zip(*cross), sigma=SIGMA),
        lambda: bref.build_cross_levels_ref(*zip(*cross), sigma=SIGMA), 3)
    nbytes = sum(cross_cost(*a)[0] for a in cross)
    records.append(kernel_record(
        "cross_solve (panel form, bf16 data)", src + "build_stage_panel.cu",
        tpu + "build_stage/build_stage.py:157",
        fl["cross_solve_levels_panel"], i16["err"]["cross_solve"], ms, plain,
        cross_tc_bound(nbytes, [a[0].shape[:2] + a[1].shape[1:2]
                                for a in cross]),
        unit=f"rank 256, bf16 fit: one grouped launch (U and "
             f"{len(cross) - 1} W levels)", turns_ms=t,
        f32_entry_ms=time_ms(lambda: bops.build_cross_levels(
            *zip(*c32), sigma=SIGMA), 3)))
    sig, cd = i16["sig16"], i16["cd16"]
    s32, cd32 = [f32(d) for d in sig], [(f32(d), li) for d, li in cd]
    ms, plain, t = turns(lambda: bops.build_gram_dist_levels(sig, **opts),
                         lambda: bref.build_gram_dist_levels_ref(sig, **opts),
                         3)
    costs = [gram_dist_cost(d, True) for d in sig]
    records.append(kernel_record(
        "gram_chol_dist (panel form, bf16 data)", src + "build_dist_panel.cu",
        tpu + "build_stage/build_stage.py:215",
        sl["gram_chol_dist_levels_panel"], i16["err"]["gram_chol_dist"], ms,
        plain, bound_ms(sum(c[0] for c in costs), sum(c[1] for c in costs)),
        unit=f"rank 256, one bf16 sigma: one grouped launch ({len(sig)} "
             "Sigma levels)", turns_ms=t,
        f32_entry_ms=time_ms(lambda: bops.build_gram_dist_levels(
            s32, **opts), 3)))
    ms, plain, t = turns(
        lambda: bops.build_cross_dist_levels(*zip(*cd), sigma=SIGMA),
        lambda: bref.build_cross_dist_levels_ref(*zip(*cd), sigma=SIGMA), 3)
    records.append(kernel_record(
        "cross_solve_dist (panel form, bf16 data)",
        src + "build_dist_panel.cu", tpu + "build_stage/build_stage.py:254",
        sl["cross_solve_dist_levels_panel"], i16["err"]["cross_solve_dist"],
        ms, plain, cross_dist_tc_bound(cd),
        unit=f"rank 256, one bf16 sigma: one grouped launch (U and "
             f"{len(cd) - 1} W levels)", turns_ms=t,
        f32_entry_ms=time_ms(lambda: bops.build_cross_dist_levels(
            *zip(*cd32), sigma=SIGMA), 3)))
    b4, b4h, b4r = g["b4"], h["b4"], r3["args"]["solve"]
    ms, plain, t = turns(lambda: lops.leaf_solve(*b4),
                         lambda: lref.hck_leaf_solve_ref(*b4), 10, True)
    ms64, plain64, t64 = turns(lambda: lops.leaf_solve(*b4h),
                               lambda: lref.hck_leaf_solve_ref(*b4h), 10,
                               True)
    rms, rplain, rt = turns(lambda: lops.leaf_solve(*b4r),
                            lambda: lref.hck_leaf_solve_ref(*b4r), 10, True)
    records.append(kernel_record(
        "leaf_solve (wide, leaves past 256 rows)", src + "leaf_solve.cu",
        tpu + "hck_leaf/hck_leaf.py:123",
        sum(rd["leaf_solve_wide"] for rd in ups), max(
            g["err"]["leaf_solve"], h["err"]["leaf_solve"]), ms, plain,
        bound_ms(*solve_cost(*b4)),
        unit=f"one launch at (g)'s round 1 (P {b4[0].shape[0]}, n0 "
             f"{b4[0].shape[1]}, r {RANK_R}, k {b4[3].shape[2]}, f32; device "
             "time)", turns_ms=t,
        f64={"shape": f"P {b4h[0].shape[0]}, n0 {b4h[0].shape[1]}, r "
                      f"{RANK_R}, k {b4h[3].shape[2]}", "ms": ms64,
             "plain_ms": plain64, "turns_ms": t64,
             "bound_ms": bound_ms(*solve_cost(*b4h))[0]},
        resident_fit={"shape": f"P {b4r[0].shape[0]}, n0 {RANK_R}, r "
                               f"{RANK_R}, k {b4r[3].shape[2]}, f32 (the "
                               "rank-256 fit's)", "ms": rms,
                      "plain_ms": rplain, "turns_ms": rt,
                      "bound_ms": bound_ms(*solve_cost(*b4r))[0]}))
    b13, b13g = h["b13"], g["b13"]
    ms, plain, t = turns(lambda: leaf_update(*b13),
                         lambda: leaf_update_ref(*b13), 5, True)
    records.append(kernel_record(
        "leaf_update (panel form)", src + "leaf_update_panel.cu",
        tpu + "update_stage/update_stage.py:62",
        sum(rd["leaf_update_panel"] for rd in ups), h["err"]["leaf_update"],
        ms, plain, bound_ms(*leaf_update_cost(*b13)),
        unit=f"one launch at (h)'s 2% insert (P {b13[0].shape[0]}, n0 "
             f"{b13[0].shape[1]}, k {b13[2].shape[1]}, f64; device time)",
        turns_ms=t, resident_round1=update_timing(b13g)))
    adiag, u, b = g["b5"]
    gen = torch.Generator(device=adiag.device).manual_seed(SEED + 56)
    o = dict(generator=gen, device=adiag.device, dtype=torch.float64)
    big = (torch.randn((256, 384, 384), **o), torch.randn((256, 384, RANK_R),
                                                           **o),
           torch.randn((256, 384, N_CLASSES), **o))
    ms, plain, t = turns(lambda: lops.leaf_matvec(adiag, u, b),
                         lambda: lref.hck_leaf_matvec_ref(adiag, u, b), 10,
                         True)
    chunks = matvec_calls(384, RANK_R, N_CLASSES, 8)
    cms, cplain, ct = turns(lambda: lops.leaf_matvec(*big),
                            lambda: lref.hck_leaf_matvec_ref(*big), 5, True)
    records.append(kernel_record(
        "leaf_matvec (grown leaves)", src + "leaf_matvec.cu",
        tpu + "hck_leaf/hck_leaf.py:70", sum(rd["leaf_matvec"] for rd in ups),
        max(g["err"]["leaf_matvec"], h["err"]["leaf_matvec"]), ms, plain,
        bound_ms(*matvec_cost(adiag, u, b)),
        library=device_ms(lambda: (torch.bmm(adiag, b), torch.bmm(u.mT, b)),
                          10),
        unit=f"one launch at (g)'s round 1 (P {adiag.shape[0]}, n0 "
             f"{adiag.shape[1]}, r {RANK_R}, k {b.shape[2]}, f32; device "
             "time)", turns_ms=t,
        library_call="torch.bmm(adiag, b) + torch.bmm(u.mT, b)",
        chunked={"shape": f"P 256, n0 384, r {RANK_R}, k {N_CLASSES}, f64",
                 "launches_a_call": chunks, "ms": cms, "plain_ms": cplain,
                 "turns_ms": ct,
                 "bound_ms": bound_ms(*matvec_cost(*big))[0]}))
    for rec in records:
        extra = ""
        if "f32_entry_ms" in rec:
            extra = (f", its f32 entry on the same data "
                     f"{rec['f32_entry_ms']:.4f} ms")
        for part in ("f64", "resident_fit", "resident_round1", "chunked"):
            if part in rec:
                p = rec[part]
                extra += (f"; {part} ({p['shape']}): kernel {p['ms']:.4f} ms,"
                          f" plain {p['plain_ms']:.4f} ms, bound "
                          f"{p['bound_ms']:.4f} ms")
        say(f"[9 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms (turns "
            f"{rec['turns_ms']}), library {rec['library_ms']} ms{extra}, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), launches "
            f"{rec['launches']}")
    return records


def phase_kernels(fit, dev) -> dict:
    """Phase 4: each kernel against its plain version on the card."""
    from repro_torch.kernels.build_stage.ref import build_cross_ref

    from repro_torch.kernels.build_stage.ops import (build_cross_levels,
                                                     build_gram,
                                                     build_gram_levels)

    model, res = fit["model"], {}
    f = model.factors
    args = fit_launches(f, fit["inv"], fit["b"])
    # B1 as krr.fit launches it: every Sigma level (with its factor) in one
    # grouped launch, the leaves' Adiag in a launch without a factor; each
    # level against its plain version
    pts, wants = zip(*args["gram"])
    grams = build_gram_levels(pts[:-1], sigma=SIGMA, jitter=JITTER)
    grams.append(build_gram(pts[-1], sigma=SIGMA, jitter=JITTER,
                            want_chol=False))
    errs = [check_build(p, w, 1e-4, got=g)
            for p, w, g in zip(pts, wants, grams)]
    res["gram_chol"] = max(e[1] for e in errs)
    say(f"[4 kernels] gram_chol_levels: Sigma of all {LEVELS} levels with "
        f"chol in one grouped launch and Adiag {tuple(pts[-1].shape)} in "
        f"one without: rel {max(e[0] for e in errs):.3e}, max|d| "
        f"{res['gram_chol']:.3e} (tolerance 1e-4 relative; every Gram "
        f"exactly symmetric) ok")
    us = build_cross_levels(*zip(*args["cross"]), sigma=SIGMA)
    errs = [check_cross(a, None, got=u) for a, u in zip(args["cross"], us)]
    res["cross_solve"] = max(e[1] for e in errs)
    say(f"[4 kernels] cross_solve_levels: U {tuple(args['cross'][0][0].shape)}"
        f" and W of levels 1..{LEVELS - 1} in one grouped launch (split "
        f"TF32), r={RANK}: rel {max(e[0] for e in errs):.3e}, max|d| "
        f"{res['cross_solve']:.3e} (componentwise 4 (2r + d) eps "
        f"|K||Linv^T||Linv| on every level) ok")
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
    # B5 at k = 1, a Lanczos step's shape (its KT = 1 instance), and at k
    # = 12, the sweep's KPCA block (two tiles of 8; 51 of a sweep's 64
    # launches)
    adiag, u, b = args["matvec"]
    for key, bk in (("leaf_matvec_k1", b[..., :1].contiguous()),
                    ("leaf_matvec_k12", torch.cat([b, b[..., :5]], 2))):
        rel, res[key] = check_leaf("matvec", (adiag, u, bk), 1e-4)
        say(f"[4 kernels] leaf_matvec at k = {bk.shape[2]} "
            f"{tuple(adiag.shape)}: rel {rel:.3e}, max|d| {res[key]:.3e} "
            f"(tolerance 1e-4 relative) ok")
    res["hck_leaf_project"] = check_project(f.u, model.plan.w_leaf)
    say(f"[4 kernels] leaf_project {tuple(f.u.shape)}: max|dc| "
        f"{res['hck_leaf_project']:.3e} (tolerance 2*n0*eps*|U|^T|b| per "
        f"entry) ok")
    local, walk, pair = bucket_inputs(f, model.plan, fit["xt"][:4096])
    for stage, a, both in (("oos_local", local, False),
                           ("oos_walk", walk, False),
                           ("oos_local_walk", pair, True)):
        err, scale = check_contract(a, name="gaussian", rtol=1e-4, pair=both)
        res[f"{stage}_err"] = err
        say(f"[4 kernels] oos_contract {stage} q={a[4 if both else 2].shape[0]}"
            f" m={a[0].shape[1]}: max|dz| {err:.3e} of max|z| {scale:.3e} "
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
            # the one-launch form: leaves of 24, parents' landmarks of 12,
            # sorted leaves; again with blocks taken in chunks of 10 rows
            leaf = torch.sort(widx).values
            both = (rnd(16, 24, 5), rnd(16, 24, 3), rnd(8, 12, 5),
                    rnd(16, 12, 3), rnd(300, 5), leaf, leaf >> 1)
            for lb in (None, 10):
                check_contract(both, name=name, rtol=rtol, pair=True,
                               leaf_block=lb)
        _, _, _, back, inv_err = check_factor(spd(5, 40), rtol)
        li = torch.linalg.inv(torch.linalg.cholesky(spd(6, 24))).contiguous()
        check_leaf("solve", (li, rnd(6, 24, 8), rnd(3, 8, 8), rnd(6, 24, 3)),
                   rtol)
        check_solve_shapes(dtype, rtol, rnd, spd, dev)
        check_matvec_shapes(rtol, rnd)
        check_update_shapes(dtype, rtol, gen, dev)
        # B6: the scalar path (r 9, a view one element in), the 16-byte
        # path (r 8), rows in two staged chunks with k past one 8-column
        # tile (n0 300, k 9), several leaves per block (n0 2)
        for (p, n0, r), k in (((6, 40, 9), 4), ((6, 40, 8), 4),
                              ((3, 300, 12), 9), ((9, 2, 16), 17)):
            check_project(rnd(p, n0, r), rnd(p, n0, k))
        check_project(rnd(6 * 40 * 8 + 1)[1:].view(6, 40, 8), rnd(6, 40, 4))
        say(f"[4 kernels] {tag} small shapes: gram_chol, cross_solve, "
            f"oos_contract and oos_local_walk (whole blocks and chunks of 10 "
            f"rows) for gaussian, imq and laplace, leaf_factor "
            f"(backward {back:.3e}, inverse {inv_err:.3e}), leaf_solve, "
            f"leaf_matvec (k 1, 3, 9, 16, 33; n0 17, 24, 40, 142, 167 in "
            f"panels of 16 rows; U one element off 16 bytes), leaf_update (n0 17, 40, k 1, 7, 33) within "
            f"{rtol} relative, leaf_project (16-byte and "
            f"scalar loads, two row chunks, k 9 and 17, several leaves a "
            f"block) within 2*n0*eps*|U|^T|b| ok")
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
    # the same in the ragged last panel of B3's kernel (n0 40)
    bad40 = torch.eye(40, device=dev).expand(2, 40, 40).clone()
    bad40[1, 35, 35] = -1.0
    lo40, _ = leaf_factor(bad40)
    sync()
    require(bool(torch.isnan(chol[1]).any() and torch.isfinite(chol[0]).all()),
            "gram_chol: an indefinite block gives NaN, no clamp")
    for what, out in (("n0 16", lo), ("n0 40, last panel", lo40)):
        require(bool(torch.isnan(out[1]).any()
                     and torch.isfinite(out[0]).all()),
                f"leaf_factor ({what}): an indefinite block gives NaN, no "
                "clamp")
    say("[4 kernels] an indefinite Gram block and an indefinite leaf (n0 16, "
        "and n0 40 in B3's ragged last panel) give NaN (no pivot clamp) ok")
    check_contract_nan(dev)
    check_contract_widths(dev)
    check_build_levels(dev)
    check_factor_sizes(dev)


def check_build_levels(dev) -> None:
    """Phase 4, small shapes: B1 and B2 grouped over ragged levels (f32
    and f64, every base kernel, d 5 and 90: 90 is past B12's tiled limit
    and takes twelve feature chunks), the update's grown leaves (n0 142
    and 167) through leaf_stage_factors (one-group launches, counted), and
    an f64 build_hck at d 90 against the plain path on the CPU with the
    same draws (to_dense within 1e-10)."""
    from repro_torch.core import hck
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.build_stage import ops as bops

    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        o = dict(dtype=dtype, device=dev)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, **o) * math.sqrt(
                2 / shape[-1])

        def linv_of(p, r):
            a = torch.randn((p, r, r), generator=gen, **o)
            return torch.linalg.inv(torch.linalg.cholesky(
                a @ a.mT / r + torch.eye(r, **o))).contiguous()

        for name in ("gaussian", "imq", "laplace"):
            for d in (5, 90):
                pts = [rnd(1, 24, d), rnd(2, 24, d), rnd(3, 70, d),
                       rnd(5, 16, d)]
                for p, g in zip(pts[:3], bops.build_gram_levels(
                        pts[:3], name=name, jitter=1e-3)):
                    check_build(p, True, rtol, name=name, jitter=1e-3, got=g)
                (g,) = bops.build_gram_levels(pts[3:], name=name, jitter=1e-3,
                                              want_chol=False)
                check_build(pts[3], False, rtol, name=name, jitter=1e-3,
                            got=g)
                cross = [(rnd(4, 48, d), rnd(4, 16, d), linv_of(4, 16)),
                         (rnd(1, 32, d), rnd(1, 16, d), linv_of(1, 16)),
                         (rnd(2, 130, d), rnd(2, 16, d), linv_of(2, 16))]
                for a, u in zip(cross, bops.build_cross_levels(
                        *zip(*cross), name=name)):
                    check_cross(a, rtol, name=name, got=u)
        say(f"[4 kernels] {str(dtype)[6:]} small shapes: gram_chol_levels "
            f"(m 24, 24, 70 with chol in one launch, 16 without in one) and "
            f"cross_solve_levels (m 48, 32, 130, r 16) grouped over ragged "
            f"levels, gaussian, imq and laplace, d 5 and 90, within {rtol} "
            f"(the cross gate componentwise) ok")
    # the grown leaves of model.update through leaf_stage_factors
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    rows = []
    for n0g in (142, 167):
        blocks = torch.randn((64, n0g, D), generator=gen, device=dev) * 0.2
        lm = torch.randn((64, RANK, D), generator=gen, device=dev) * 0.2
        a = torch.randn((64, RANK, RANK), generator=gen, device=dev)
        li = torch.linalg.inv(torch.linalg.cholesky(
            a @ a.mT / RANK + torch.eye(RANK, device=dev))).contiguous()
        (adiag, u), launches, plain_calls = counted(
            lambda: hck.leaf_stage_factors(blocks, lm, li, ker))
        require_launches(f"leaf_stage_factors at n0 {n0g}", launches,
                         plain_calls, {"gram_chol": 1, "cross_solve": 1})
        g_err = check_build(blocks, False, 1e-4, got=(adiag, None))[1]
        c_rel, c_err = check_cross((blocks, lm, li), None, got=u)
        rows.append(f"n0 {n0g}: Adiag max|d| {g_err:.3e}, U rel {c_rel:.3e}")
    say("[4 kernels] leaf_stage_factors at the grown leaf sizes (one-group "
        "launches of B1 without a factor and of B2, counted): "
        + "; ".join(rows) + " ok")
    # an f64 build at d 90, card against CPU, the same draws
    levels, n, d = 3, 1024, 90
    x = torch.randn((n, d), generator=gen, device=dev,
                    dtype=torch.float64) * math.sqrt(2 / d)
    dirs = [torch.randn((1 << lvl, d), generator=gen, device=dev,
                        dtype=torch.float64) for lvl in range(levels)]
    idx = [hck.landmark_indices(1 << lvl, n >> lvl, 16, device=dev,
                                generator=gen) for lvl in range(levels)]
    ker64 = BaseKernel("laplace", 2.0, 1e-6)
    fc, launches, plain_calls = counted(lambda: hck.build_hck(
        x, levels=levels, rank=16, kernel=ker64, directions=dirs,
        landmark_index=idx))
    require_launches("f64 build_hck at d 90", launches, plain_calls,
                     {"gram_chol_levels": 1, "gram_chol": 1,
                      "cross_solve_levels": 1})
    fp = hck.build_hck(x.cpu(), levels=levels, rank=16, kernel=ker64,
                       directions=[t.cpu() for t in dirs],
                       landmark_index=[t.cpu() for t in idx])
    gap = rel_max(hck.to_dense(fc).cpu(), hck.to_dense(fp))
    require(gap <= 1e-10, f"f64 build_hck d 90 card vs CPU to_dense rel "
            f"{gap:.3e} <= 1e-10")
    say(f"[4 kernels] f64 build_hck (n {n}, d {d}, laplace, rank 16: two "
        f"grouped launches and Adiag's) vs the plain path on the CPU with "
        f"the same draws: to_dense rel {gap:.3e} <= 1e-10 ok")


def factor_leaves(p, n0, dtype, gen):
    """p SPD leaves of n0: Gaussian Grams (sigma 1) of close points in D
    features (mean squared distance ~0.5) plus 1e-2 I, kappa ~4e3 to 7e3
    (tests/test_torch_leaf_policy_redesign.py's leaves, drawn here)."""
    x = torch.randn((p, n0, D), generator=gen, device=gen.device,
                    dtype=torch.float64) * (0.5 / math.sqrt(D))
    k = torch.exp(-0.5 * torch.cdist(x, x) ** 2)
    return (k + 1e-2 * torch.eye(n0, dtype=torch.float64, device=gen.device)
            ).to(dtype).contiguous()


def check_solve_shapes(dtype, rtol, rnd, spd, dev) -> None:
    """Phase 4, small shapes: B4 where it stages Linv's triangle and U and
    where it reads either in place (f32: n0 17 with 4-byte copies, k 1, 7
    and 16 (two column groups), S = P and P/2, n0 240 with U read in
    place; f64: n0 142 with U read in place, n0 240 with both), each within
    ``rtol`` of its plain version; Linv exactly lower triangular, as every
    producer of the port writes it."""
    from repro_torch.kernels.hck_leaf.ops import solve_plan

    shapes = [(6, 17, 8, 1, 3), (6, 16, 8, 7, 6), (6, 24, 12, 16, 3)]
    shapes += ([(4, 240, 128, 7, 2)] if dtype == torch.float32 else
               [(4, 142, 128, 7, 2), (2, 240, 128, 7, 1)])
    seen = set()
    for p, n0, r, k, s in shapes:
        li = torch.linalg.solve_triangular(
            torch.linalg.cholesky(spd(p, n0)),
            torch.eye(n0, dtype=dtype, device=dev).expand(
                p, n0, n0), upper=False).tril().contiguous()
        args = (li, rnd(p, n0, r) / math.sqrt(n0), rnd(s, r, r) / r,
                rnd(p, n0, k))
        plan = solve_plan(n0, r, k, li.element_size(), li.data_ptr(),
                          args[1].data_ptr(), args[2].data_ptr())
        seen.add((plan["stage_l"], plan["stage_u"]))
        check_leaf("solve", args, rtol)
    say(f"[4 kernels] {str(dtype)[6:]} leaf_solve at (P, n0, r, k, S) "
        f"{shapes}: staged (triangle, U) {sorted(seen)} within {rtol} ok")


def check_matvec_shapes(rtol, rnd) -> None:
    """Phase 4, small shapes: B5 at k 1 (its KT = 1 instance), 3 and 9 (one
    and two tiles of 8), 33 (five), odd n0 (panels off 16 bytes), n0 142
    (a ragged last panel), n0 167 with r 128 and k 16 (panels of 16 rows)
    and U a view one element in (copied element by element), against its
    plain version."""
    from repro_torch.kernels.hck_leaf.ops import matvec_plan

    for (p, n0, r), k in (((6, 24, 8), 3), ((6, 17, 9), 1), ((5, 40, 12), 9),
                          ((7, 16, 16), 33), ((9, 142, 128), 7),
                          ((3, 17, 9), 16), ((5, 167, 128), 16)):
        args = (rnd(p, n0, n0), rnd(p, n0, r), rnd(p, n0, k))
        if n0 == 167:
            require(matvec_plan(n0, r, k, args[0].element_size())["rows"]
                    == 16, "leaf_matvec at n0 167, r 128, k 16 takes panels "
                    "of 16 rows")
        check_leaf("matvec", args, rtol)
    u = rnd(6 * 24 * 8 + 1)[1:].view(6, 24, 8)
    check_leaf("matvec", (rnd(6, 24, 24), u, rnd(6, 24, 5)), rtol)


def check_update_shapes(dtype, rtol, gen, dev) -> None:
    """Phase 4, small shapes: B13 on bordered SPD leaves at n0 17 (panels off
    16 bytes) and 40 (a ragged last panel), k 1, 7 and 33 (the factor of S
    past one panel of 32), against its plain version (check_update_kernel's
    gates)."""
    o = dict(dtype=torch.float64, device=dev)
    for p, n0, k in ((6, 17, 7), (9, 17, 1), (5, 40, 33)):
        a = torch.randn((p, n0 + k, n0 + k), generator=gen, **o)
        full = a @ a.mT / (n0 + k) + torch.eye(n0 + k, **o)
        lo = torch.linalg.cholesky(full[:, :n0, :n0])
        linv = torch.linalg.inv(lo).tril()
        check_update_kernel(*(t.to(dtype).contiguous() for t in (
            lo, linv, full[:, n0:, :n0], full[:, n0:, n0:])), rtol)


def check_contract_widths(dev) -> None:
    """Phase 4: B7 at the widths of the repo's configs beside covtype's
    (yearpredictionmsd d 90, mnist d 780 with 10 classes; mnist's blocks
    do not fit a slot whole and go in chunks), f32 and f64, one stage and
    the one-launch form, gaussian, against the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    rows = []
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        for d, k in ((90, 1), (780, 10)):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, dtype=dtype,
                                   device=dev) / math.sqrt(d)
            leaf = torch.sort(torch.randint(0, 32, (512,), generator=gen,
                                            device=dev)).values
            both = (rnd(32, 128, d), rnd(32, 128, k), rnd(16, 128, d),
                    rnd(32, 128, k), rnd(512, d), leaf, leaf >> 1)
            e1 = check_contract(both[:2] + both[4:6] + both[5:6],
                                name="gaussian", rtol=rtol)[0]
            e2 = check_contract(both, name="gaussian", rtol=rtol,
                                pair=True)[0]
            rows.append(f"{str(dtype)[6:]} d {d} k {k}: {e1:.3e}, {e2:.3e}")
    say("[4 kernels] oos_contract and oos_local_walk at d 90 and 780 (m "
        "128, 512 queries), max|dz|: " + "; ".join(rows) + " ok")


def check_factor_sizes(dev) -> None:
    """Phase 4: B3's gates (check_factor) at the grown leaf sizes and the
    largest tile the kernel takes: n0 142, 167 and 240 in f32 (ragged last
    panels of 14, 7 and 16 columns), 169 in f64; each launch of the
    kernel (counted)."""
    from repro_torch.kernels.hck_leaf.ops import leaf_factor

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows = []
    for n0, dtype, p in ((142, torch.float32, 512), (167, torch.float32, 256),
                         (240, torch.float32, 128), (169, torch.float64, 128)):
        dleaf = factor_leaves(p, n0, dtype, gen)
        before = leaf_factor.launches
        rtol = 1e-4 if dtype == torch.float32 else 1e-10
        rel, rel_inv, _, back, inv_err = check_factor(dleaf, rtol)
        require(leaf_factor.launches == before + 1,
                f"leaf_factor at n0 {n0} launched its kernel")
        rows.append(f"n0 {n0} {str(dtype)[6:]} (P {p}): L rel {rel:.3e}, "
                    f"L^-1 rel {rel_inv:.3e}, backward {back:.3e}, inverse "
                    f"{inv_err:.3e}")
    say("[4 kernels] leaf_factor at the grown and largest "
        "leaf sizes: " + "; ".join(rows) + " (L within 1e-4 in f32, L and "
        "L^-1 within 1e-10 in f64, both componentwise bounds) ok")


def phase_exact(dev) -> None:
    """Phase 5: fits at n = 4,096 against the dense oracle."""
    from repro_torch.core import hmatrix, krr, oos
    from repro_torch.core.hck import landmark_indices, to_dense
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.registry import SolveConfig

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
    def refit(**kw):
        return krr.fit(x32, labels, kernel=ker, lam=LAM, rank=RANK,
                       leaf_size=LEAF, classification=True, directions=dirs,
                       landmark_index=idx, **kw)

    tf32_guard(refit, m32, q, dev, lambda: refit(
        solve_config=SolveConfig(precision="bf16")))


def tf32_guard(refit, m32, q, dev, refit16) -> None:
    """Phase 5, ROADMAP C11: the port's entry points keep single-pass TF32
    off whatever the caller allows.  The f32 fit at n = 4,096 (``refit``,
    which gave ``m32``), the same fit under the bf16 policy (``refit16``,
    whose factor products are float32 too) and a small ``ssd_chunked``
    call run again under
    ``torch.set_float32_matmul_precision("high")`` and must give the same
    outputs, bit for bit, as with the flag off (the fit is first repeated
    with the flag off: it is deterministic); the refitted model's
    predictions are made under the flag too, so the queries' routing
    projections and the engine run under it.  Control: a plain f32 product
    under the flag strays ~1e3 times further from its f64 value than one
    without, so the flag does act on this card."""
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    b, s, h, p, g, n = 2, 512, 8, 64, 2, 64
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(torch.rand((h,), generator=gen, device=dev))
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev)
              for _ in range(2))
    u, v = (torch.randn((512, 512), generator=gen, device=dev)
            for _ in range(2))
    exact = u.double() @ v.double()
    y_off = ssd_chunked(x, dt, a, bm, cm)
    again = refit()
    m16 = refit16()
    z16 = m16.predict(q)
    off_err = rel_max(u @ v, exact)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        hi_err = rel_max(u @ v, exact)
        m_hi = refit()
        z_hi = m_hi.predict(q)
        m16_hi = refit16()
        z16_hi = m16_hi.predict(q)
        y_hi = ssd_chunked(x, dt, a, bm, cm)
        after = (torch.get_float32_matmul_precision(),
                  torch.backends.cudnn.allow_tf32)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
    sync()
    require(torch.equal(again.alpha, m32.alpha),
            "the f32 fit at n=4,096 repeats bit for bit")
    require(hi_err > 100 * off_err, f"control: an f32 product under "
            f"precision 'high' is off by {hi_err:.3e} against {off_err:.3e} "
            "without it (TF32 acts on this card)")
    require(after == ("high", True), "the caller's flags are back after "
            f"the calls: {after}")
    require(torch.equal(m_hi.alpha, m32.alpha)
            and torch.equal(z_hi, m32.predict(q)),
            "krr.fit under set_float32_matmul_precision('high') gives the "
            "same alpha and predictions as without")
    require(torch.equal(m16_hi.alpha, m16.alpha) and torch.equal(z16_hi, z16),
            "the bf16 fit under set_float32_matmul_precision('high') gives "
            "the same alpha and predictions as without")
    require(torch.equal(y_hi, y_off), "ssd_chunked under "
            "set_float32_matmul_precision('high') gives the same output as "
            "without")
    say(f"[5 exact] TF32 guard (ROADMAP C11): under "
        f"set_float32_matmul_precision('high') and cuDNN TF32 on, the f32 "
        f"fit at n={EXACT_N} (alpha, predictions), the same fit under the "
        f"bf16 policy and ssd_chunked "
        f"{(b, s, h, p)} "
        f"equal their outputs with the flags off, bit for bit; the caller's "
        f"flags are restored; control: a 512^2 f32 product under the flag "
        f"rel {hi_err:.3e} from f64, {off_err:.3e} without ok")


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
    calls0 = eng.stats["calls"]
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
    calls = eng.stats["calls"] - calls0
    require(launches["oos_contract"] == launches["oos_contract_pair"] == calls
            and not any(v for key, v in launches.items()
                        if key not in ("oos_contract", "oos_contract_pair")),
            f"the serving path launched B7 once a bucket ({calls} buckets) "
            f"and nothing else: {launches}")
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


def device_ops(fn) -> tuple[float, float]:
    """One call of ``fn`` under torch.profiler: (device ms, device ops),
    or (nan, nan) when the profiler recorded no device time."""
    rows = device_rows(fn, 1)
    if not rows:
        return float("nan"), float("nan")
    return sum(r[1] for r in rows) / 1e3, sum(r[2] for r in rows)


PAIRS_ROUNDS = 6     # (a, b, b, a) x 6: 12 adjacent pairs


def paired_turns(a, b, rounds: int = PAIRS_ROUNDS) -> dict:
    """Wall ms of ``a`` and ``b`` in turns (a, b, b, a) x ``rounds`` (host
    clock, synchronised before and after each call): both medians, and the
    quartiles, least and largest of the adjacent pairs' relative
    differences (b - a) / a."""
    ta, tb = [], []
    a(), b()
    for _ in range(rounds):
        for fn, out in ((a, ta), (b, tb), (b, tb), (a, ta)):
            sync()
            t = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t) * 1e3)
    d = sorted((y - x) / x for x, y in zip(ta, tb))
    q1, _, q3 = statistics.quantiles(d, n=4)
    return {"a_ms": statistics.median(ta), "b_ms": statistics.median(tb),
            "pairs": len(d), "min": d[0], "q1": q1,
            "median": statistics.median(d), "q3": q3, "max": d[-1]}


def pairs_text(r: dict, limit: float | None = None) -> str:
    """One line of :func:`paired_turns`' result; with ``limit``, the
    verdict on "b is at most ``limit`` slower": met when the upper
    quartile is within it, not met when the lower one is past it, else
    unresolved."""
    text = (f"{r['a_ms']:.3f} / {r['b_ms']:.3f} ms (medians of "
            f"{r['pairs']}); pairs (b - a) / a: median "
            f"{r['median'] * 100:+.2f}%, quartiles {r['q1'] * 100:+.2f}% .. "
            f"{r['q3'] * 100:+.2f}%, range {r['min'] * 100:+.2f}% .. "
            f"{r['max'] * 100:+.2f}%")
    if limit is not None:
        verdict = ("met" if r["q3"] <= limit else
                   "not met" if r["q1"] > limit else "unresolved")
        text += f"; at most {limit * 100:+.0f}%: {verdict}"
    return text


def registry_probes(fit, dev) -> dict:
    """Phase 6b, part 1: the fit with checks on against checks off."""
    from repro_torch.core import krr
    from repro_torch.kernels.registry import SolveConfig

    ker = fit["model"].kernel
    x, labels = fit["x"], fit["labels"]

    def fit_with(checks):
        return krr.fit(x, labels, kernel=ker, lam=LAM, rank=RANK,
                       leaf_size=LEAF, classification=True,
                       solve_config=SolveConfig(checks=checks),
                       generator=torch.Generator(device=dev).manual_seed(
                           SEED + 1))

    runs = {}
    for checks in (False, True):
        m, launches, plain = counted(lambda: fit_with(checks))
        require(launches == fit["launches"] and not any(plain.values()),
                f"checks={checks}: the fit's launches {launches} are phase "
                f"3's {fit['launches']}")
        runs[checks] = m
    require(torch.equal(runs[True].alpha, runs[False].alpha)
            and torch.equal(runs[False].alpha, fit["model"].alpha),
            "checks on and off give phase 3's weights bit for bit")
    cost = paired_turns(lambda: fit_with(False), lambda: fit_with(True))
    ops = {c: device_ops(lambda c=c: fit_with(c)) for c in (False, True)}
    # _invert_tail's solve_ex (no error check, no host sync) against
    # solve (an error check, so a host sync a level), bits compared
    from repro_torch.core import hmatrix

    f, solve_ex = runs[False].factors, torch.linalg.solve_ex

    def with_solve():
        torch.linalg.solve_ex = lambda a, b: (torch.linalg.solve(a, b), None)
        try:
            return hmatrix.invert_with_leaf(f, LAM)
        finally:
            torch.linalg.solve_ex = solve_ex

    def invert():
        return hmatrix.invert_with_leaf(f, LAM)

    same = torch.equal(with_solve()[0].sigma[0], invert()[0].sigma[0])
    tail = paired_turns(with_solve, invert)
    # each probe of the fit alone, warm, on the fitted model (host clock
    # around the call, synchronised before it)
    from repro_torch.runtime import health

    m, on_cfg = runs[True], SolveConfig(checks=True)
    probes = {"probe_factors": lambda: health.probe_factors(m.factors,
                                                            on_cfg),
              "probe_leaf_factor": lambda: health.probe_leaf_factor(
                  m.leaf_lo, on_cfg),
              "check_finite(alpha)": lambda: health.check_finite(
                  "solve", m.alpha, config=on_cfg)}
    each = {}
    for name, fn in probes.items():
        ts = []
        for _ in range(7):
            sync()
            t = time.perf_counter()
            require(fn() is True, f"{name} ran and passed")
            ts.append(time.perf_counter() - t)
        each[name] = sorted(ts)[3] * 1e3
    say(f"[6b registry] {card()}: krr.fit at full width, launches with "
        f"checks on = off = phase 3's {fit['launches']}; weights bit for "
        f"bit equal")
    say(f"[6b registry] probe cost, fits in turns (off, on, on, off) x "
        f"{PAIRS_ROUNDS}, off / on: {pairs_text(cost, 0.03)} (the README "
        f"claims <= 3%); device ms / device ops in one profiled fit: off "
        f"{ops[False][0]:.3f} / {ops[False][1]:.0f}, on {ops[True][0]:.3f} / "
        f"{ops[True][1]:.0f} -> {ops[True][1] - ops[False][1]:.0f} extra "
        f"device ops; each probe alone (median of 7, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in each.items()))
    say(f"[6b registry] invert_with_leaf in turns, _invert_tail with "
        f"solve / with solve_ex: {pairs_text(tail, 0.0)}; bits equal: "
        f"{same}")
    require(same, "solve_ex and solve give the same Sigma bit for bit")
    return {"fit": cost, "ops": ops, "each_ms": each, "solve_ex": tail}


def registry_launcher(fit, served) -> dict:
    """Phase 6b, part 2: the launcher's --task krr at covtype width, and
    phase 3's model served through the loop against its raw engine."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serving.predict_service import ModelRegistry
    from repro_torch.serving.serve_loop import KRRServeLoop

    argv = ["--task", "krr", "--n", str(N_TRAIN), "--d", str(D), "--rank",
            str(RANK), "--sigma", repr(math.sqrt(D / 2)), "--queries",
            str(N_TEST), "--micro-batch", "4096", "--update-batch",
            str(UPDATE_Q), "--rollback", "--seed", str(SEED)]
    out, launches, plain = counted(lambda: launch_serve.main(argv))
    loop = out["loop"]
    require((loop["failures"], loop["retries"], loop["degraded_batches"],
             loop["deadline_misses"]) == (0, 0, 0, 0),
            f"the clean stream has no failure, retry, degraded batch or "
            f"deadline miss: {loop}")
    require(out["versions_in_order"] == [1, 2, 1],
            f"versions served in order {out['versions_in_order']} == [1, 2, 1]")
    require(out["rollback_bitwise"] is True,
            "after the rollback v1 serves bitwise what it served before")
    require(not any(plain.values()), f"no plain version ran: {plain}")
    for name in ("gram_chol_levels", "cross_solve_levels", "leaf_factor",
                 "leaf_solve", "leaf_matvec", "hck_leaf_project",
                 "oos_contract", "leaf_update"):
        require(launches[name] > 0, f"the launcher launched {name}")
    say(f"[6b registry] {card()}: launch.serve --task krr {' '.join(argv[2:])}"
        f": fit {out['fit_s']:.3f} s, publish+warmup "
        f"{out['publish_warmup_s']:.3f} s, update of {UPDATE_Q} + publish "
        f"(warmup) mid-stream {out['swap_s']:.3f} s (k {out['update']['k']}"
        f"/leaf, residual {out['update']['residual']:.3e}), rollback "
        f"{out['rollback_s'] * 1e3:.3f} ms")
    say(f"[6b registry] loop: {N_TEST} queries in batches of 4096: "
        f"{out['qps']:.0f} queries/s over the stream (update included), "
        f"{out['qps_serving']:.0f} queries/s of serving time, p50 "
        f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms (of "
        f"{loop['batches']}, each whole loop.serve call; the engine up to "
        f"its sync, without the probe: p50 {out['engine_p50_ms']:.3f} ms); "
        f"phase 6's raw engine: {served['qps_full']:.0f} queries/s on one "
        f"request of {N_TEST}, p50 {served['p50_ms']:.3f} ms, p99 "
        f"{served['p99_ms']:.3f} ms over 16 requests of 1-4096")
    say(f"[6b registry] loop stats {loop}; registry stats "
        f"{out['registry_stats']}; launches {launches}")

    # phase 3's model: 8 batches of 4,096 through the raw engine (no sync
    # between batches) against the loop (a sync and a probe a batch)
    reg = ModelRegistry(fit["model"], warmup=True)
    lp, eng = KRRServeLoop(reg), reg.live.engine
    batches = [fit["xt"][i * 4096:(i + 1) * 4096] for i in range(8)]
    turns = paired_turns(lambda: [eng(q) for q in batches],
                         lambda: [lp.serve(q) for q in batches])
    require(lp.stats()["failures"] == 0, f"the loop's turns: {lp.stats()}")
    say(f"[6b registry] {card()}: 8 batches of 4,096 in turns, raw engine "
        f"/ loop: {pairs_text(turns)}; a batch {turns['a_ms'] / 8:.3f} / "
        f"{turns['b_ms'] / 8:.3f} ms")
    out["turns"] = turns
    return out


def registry_faults(fit, dev) -> dict:
    """Phase 6b, part 3: the injected faults at full width."""
    from repro_torch.core import oos
    from repro_torch.core.partition import route
    from repro_torch.kernels.registry import SolveConfig
    from repro_torch.runtime import health, recover
    from repro_torch.serving.predict_service import (ModelRegistry,
                                                     PredictEngine)
    from repro_torch.serving.serve_loop import KRRServeLoop
    from repro_torch.testing import faultinject as fi

    model, xt = fit["model"], fit["xt"]
    f, ker, cfg = model.factors, model.kernel, SolveConfig(checks=True)
    q = xt[:4096]
    out = {}

    def note(what, launches):
        used = {k: v for k, v in launches.items() if v}
        say(f"[6b registry] {what}; launches {used}")

    # a NaN in U: detected with the reference's stage and statistic, and
    # repaired on the frozen hierarchy
    bad = fi.poison_factor(f, "u", leaf=1)
    try:
        health.probe_factors(bad, cfg)
        err = None
    except health.NumericalFailure as e:
        err = e
    require(err is not None and (err.stage, err.statistic, err.leaf) == (
        "build_cross", "nonfinite_count", 1), f"probe_factors on U: {err}")
    (rep, audit), launches, _ = counted(
        lambda: recover.repair_factors(bad, ker, cfg))
    require(audit.recovered and audit.rungs == ["probe", "refit_frozen"],
            f"repair_factors: {audit.rungs}")
    z_rep = PredictEngine(rep, oos.prepare(rep, model.alpha), ker)(q)
    z = model.predict(q)
    rel = rel_max(z_rep, z)
    require(rel <= 1e-4, f"repaired predictions rel {rel:.3e} <= 1e-4")
    bitwise = torch.equal(rep.u, f.u) and torch.equal(rep.adiag, f.adiag)
    note(f"NaN in U: {err.stage}/{err.statistic} leaf {err.leaf}; "
         f"repair_factors rungs {audit.rungs}, predictions rel {rel:.3e} "
         f"(<= 1e-4), factors bitwise the clean ones: {bitwise}", launches)
    out["repair_rel"], out["repair_bitwise"] = rel, bitwise

    # an indefinite leaf: ridge escalation
    bad = fi.indefinite_leaf(f, leaf=2, shift=5 * LAM)
    g, launches, _ = counted(
        lambda: recover.invert_guarded(bad, LAM, cfg, kernel=ker))
    require(g.audit.recovered and not g.audit.attempts[0].ok
            and g.audit.attempts[0].failure["stage"] == "leaf_factor",
            f"invert_guarded: {g.audit.to_dict()}")
    note(f"indefinite leaf 2: invert_guarded rungs {g.audit.rungs}, "
         f"first failure {g.audit.attempts[0].failure['statistic']}, ridge "
         f"{g.ridge:g}", launches)

    # a poisoned model (plan entry of leaf 0) behind a canary of 1,024
    # held-back queries, those of them that route to leaf 0 first
    leaf = route(f.tree, xt)
    hit = xt[leaf == 0][:32]
    canary = torch.cat([hit, xt[-(1024 - hit.shape[0]):]])
    reg = ModelRegistry(model, tag="fit", canary=canary)
    before = (reg.live_version, reg.versions())
    try:
        counted(lambda: reg.publish(fi.poisoned_model(model), tag="bad"))
        err = None
    except health.NumericalFailure as e:
        err = e
    launches, _ = read_counts()
    st = reg.stats
    require(err is not None and err.stage == "serving.canary"
            and (reg.live_version, reg.versions()) == before
            and st["canary_rejects"] == 1
            and st["last_reject"]["stage"] == "serving.canary",
            f"the canary rejects the poisoned model: {err}, {st}")
    note(f"poisoned model ({hit.shape[0]} of the 1,024 canary queries "
         f"route to its poisoned leaf): publish raised "
         f"{err.stage}/{err.statistic}; "
         f"registry stats {st}", launches)
    # the same gate as users would set it up: 1,024 held-back queries,
    # none chosen for the poisoned leaf (a leaf escapes such a canary
    # with chance (1 - 1/leaves)^1024 under uniform routing)
    unaimed = xt[-1024:]
    n_hit = int((leaf[-1024:] == 0).sum())
    reg_u = ModelRegistry(model, tag="fit", canary=unaimed)
    try:
        _, launches, _ = counted(
            lambda: reg_u.publish(fi.poisoned_model(model), tag="bad"))
        caught = False
    except health.NumericalFailure:
        launches, _ = read_counts()
        caught = True
    require(caught == (n_hit > 0),
            f"an unaimed canary rejects exactly when a query routes to the "
            f"poisoned leaf: {n_hit} route there, rejected {caught}")
    out["unaimed_canary"] = {"hits": n_hit, "rejected": caught}
    note(f"an unaimed canary (the last 1,024 test queries): {n_hit} route "
         f"to the poisoned leaf, so it "
         f"{'rejected' if caught else 'would have published'} the poisoned "
         f"model (escape chance at {f.num_leaves} leaves: "
         f"{(1 - 1 / f.num_leaves) ** 1024:.3f})", launches)

    # an engine that goes bad after its canary: retries, then degraded
    loop = KRRServeLoop(reg, max_retries=2)
    loop.serve(q)                                    # v1 is the last good
    v2 = reg.publish(model, tag="v2")
    fi.hijack_live_engine(reg, lambda e: fi.FlakyEngine(e, fail_first=3))
    (first, second), launches, _ = counted(
        lambda: (loop.serve(q), loop.serve(q)))
    st = loop.stats()
    require(first.degraded and first.version == 1 and first.retries == 2
            and not second.degraded and second.version == v2
            and (st["failures"], st["retries"], st["degraded_batches"])
            == (3, 2, 1) and torch.equal(first.z, z),
            f"flaky engine: {first}, {second}, {st}")
    note(f"FlakyEngine (NaN for 3 calls) in v{v2}: batch 1 served degraded "
         f"by v{first.version} after {first.retries} retries, batch 2 by "
         f"v{second.version}; loop stats {st}", launches)

    # a guarded online update over a poisoned cached inverse
    reg = ModelRegistry(fi.poison_cached_inverse(model), tag="fit")
    x_new, y_new = fresh_points(UPDATE_Q, SEED + 40, dev)
    sync()
    t = time.perf_counter()
    (v, info), launches, _ = counted(lambda: reg.update_and_publish(
        x_new, y_new, guarded=True, tag="update"))
    t_up = time.perf_counter() - t
    require(v == 2 and reg.live_version == 2 and info.converged
            and bool(torch.isfinite(reg.predict(q)[0]).all()),
            f"guarded update_and_publish: {info}")
    audit = reg.last_audit
    require(audit is not None and audit.recovered and audit.rungs[-1].startswith("re-precondition"),
            f"update_guarded: {audit.rungs}")
    note(f"update_and_publish(guarded=True) of {UPDATE_Q} arrivals over a "
         f"poisoned cached inverse: {t_up * 1e3:.1f} ms (first failure "
         f"{audit.attempts[0].failure['stage']}/"
         f"{audit.attempts[0].failure['statistic']}), rungs {audit.rungs}",
         launches)
    out["guarded_update_ms"] = t_up * 1e3
    return out


def phase_registry(fit, served, dev) -> dict:
    """Phase 6b: probes, the launcher's --task krr and faults at full
    width."""
    res = {"probes": registry_probes(fit, dev),
           "launcher": registry_launcher(fit, served),
           "faults": registry_faults(fit, dev)}
    torch.cuda.empty_cache()
    return res


def after_padding(fit, dev) -> torch.Generator:
    """A generator in the state krr.fit's has after it padded phase 3's
    data: what it draws next are the fit's (and the plan's) tree and
    landmarks."""
    from repro_torch.core.partition import pad_points

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    pad_points(fit["x"], fit["labels"], LEAF, LEVELS, generator=gen)
    return gen


def cross_tc_bound(nbytes, shapes):
    """The least time of a grouped cross kernel's tensor-core route (B2's
    and B9's) over levels of (B, m, r) shapes: the larger of ``nbytes``,
    three TF32 passes over the two triangular products at PEAK_TF32, and
    one exp (or rsqrt) an entry of K at PEAK_SFU."""
    products = sum(2 * b * m * r * (r + 1) for b, m, r in shapes)
    entries = sum(b * m * r for b, m, r in shapes)
    times = {"bytes": nbytes / PEAK_BYTES,
             "operations": max(3 * products / PEAK_TF32,
                               entries / PEAK_SFU)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def cross_dist_tc_bound(pairs):
    """cross_tc_bound of the grouped cross_solve_dist over (dist, linv)
    pairs, with cross_dist_cost's bytes (D and Linv read once, U written
    once)."""
    return cross_tc_bound(sum(cross_dist_cost(d, li)[0] for d, li in pairs),
                          [tuple(d.shape) for d, _ in pairs])


def sweep_timing(sw, res) -> list[dict]:
    """Phase 9, sweep: B8 and B9 at sigma 1, per sigma: the grouped launches
    of the path beside their bounds and plain times; parts: the largest
    level alone and the top levels; B3's stacked launch at G = 4 against
    four single launches."""
    from repro_torch.core import hmatrix
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.build_stage import ref as bref
    from repro_torch.kernels.hck_leaf import ops as lops
    from repro_torch.kernels.hck_leaf import ref as lref

    args = sweep_launches(sw["plan"], sw["f1"])
    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    sl, gl = sw["launches"], sw["grid_launches"]
    opts = dict(sigma=SIGMA, jitter=JITTER)

    def gram_part(ds):
        cost = [gram_dist_cost(d, True) for d in ds]
        return {"ms": time_ms(lambda: bops.build_gram_dist_levels(ds, **opts),
                              5),
                "plain_ms": time_ms(
                    lambda: bref.build_gram_dist_levels_ref(ds, **opts), 3),
                "bound_ms": bound_ms(sum(c[0] for c in cost),
                                     sum(c[1] for c in cost))[0]}

    sig = args["sigma"]
    parts = {"sigma_levels": gram_part(sig),
             "sigma_largest_level": gram_part(sig[-1:]),
             "sigma_top_levels": gram_part(sig[:-1])}
    ad = args["adiag"]
    adiag = {"ms": time_ms(lambda: bops.build_gram_dist(
                 ad, want_chol=False, **opts), 5),
             "plain_ms": time_ms(lambda: bref.build_gram_dist_ref(
                 ad, want_chol=False, **opts), 3),
             "bound_ms": bound_ms(*gram_dist_cost(ad, False))[0]}
    costs = [gram_dist_cost(d, True) for d in sig] + [gram_dist_cost(ad,
                                                                     False)]
    total = parts["sigma_levels"]
    records = [kernel_record(
        "gram_chol_dist", src + "build_dist.cu",
        tpu + "build_stage/build_stage.py:215",
        sl["gram_chol_dist_levels"] + sl["gram_chol_dist"],
        res["gram_chol_dist"], total["ms"] + adiag["ms"],
        total["plain_ms"] + adiag["plain_ms"],
        bound_ms(sum(c[0] for c in costs), sum(c[1] for c in costs)),
        unit=f"one sigma: one grouped launch ({len(sig)} Sigma levels) "
             "and the leaves' Adiag (gram_dist)",
        kernel="grouped over the levels, B3's blocked factor "
               "(chol_blocked.cuh)",
        launches_grouped=sl["gram_chol_dist_levels"],
        launches_per_mle_grid=(gl["gram_chol_dist_levels"]
                               + gl["gram_chol_dist"]), **parts,
        adiag=adiag)]

    def cross_part(pairs):
        ds, lis = zip(*pairs)
        return {"ms": time_ms(lambda: bops.build_cross_dist_levels(
                    ds, lis, sigma=SIGMA), 5),
                "plain_ms": time_ms(lambda: bref.build_cross_dist_levels_ref(
                    ds, lis, sigma=SIGMA), 3),
                "bound_ms": cross_dist_tc_bound(pairs)[0],
                "bound_f32_ms": bound_ms(
                    sum(cross_dist_cost(*a)[0] for a in pairs),
                    sum(cross_dist_cost(*a)[1] for a in pairs))[0]}

    cross = args["cross"]
    parts = {"all": cross_part(cross), "u": cross_part(cross[:1]),
             "w_levels": cross_part(cross[1:]),
             "w_largest_level": cross_part(cross[-1:])}
    total = parts.pop("all")
    records.append(kernel_record(
        "cross_solve_dist", src + "build_dist.cu",
        tpu + "build_stage/build_stage.py:254",
        sl["cross_solve_dist_levels"] + sl["cross_solve_dist"],
        res["cross_solve_dist"], total["ms"], total["plain_ms"],
        cross_dist_tc_bound(cross),
        unit=f"one sigma: one grouped launch (U and {len(cross) - 1} W "
             "levels)",
        kernel="grouped over the levels, split TF32 on mma.sync "
               "(cross_tc.cuh)",
        launches_grouped=sl["cross_solve_dist_levels"],
        launches_per_mle_grid=(gl["cross_solve_dist_levels"]
                               + gl["cross_solve_dist"]),
        bound_f32_ms=total["bound_f32_ms"], **parts))
    for rec in records:
        say(f"[9 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), launches {rec['launches']} on the sweep "
            f"path ({rec['launches_grouped']} grouped), "
            f"{rec['launches_per_mle_grid']} per mle_grid")
        for key in ("sigma_levels", "sigma_largest_level",
                    "sigma_top_levels", "adiag", "u", "w_levels",
                    "w_largest_level"):
            if key in rec:
                p = rec[key]
                say(f"[9 timing]   {rec['name']} {key}: kernel "
                    f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound "
                    f"{p['bound_ms']:.4f} ms")
    say(f"[9 timing] cross_solve_dist f32 CUDA-core bound "
        f"{records[1]['bound_f32_ms']:.4f} ms")
    # B3 stacked over the grid (invert_multi) against one launch per ridge
    f = sw["f1"]
    eye = torch.eye(LEAF, device=f.adiag.device)
    ridges = torch.tensor(LAMS, device=f.adiag.device)
    dleaf = (hmatrix._leaf_schur(f)[None] + ridges[:, None, None, None]
             * eye).reshape(len(LAMS) * f.num_leaves, LEAF, LEAF)
    singles = dleaf.view(len(LAMS), f.num_leaves, LEAF, LEAF)
    stacked = time_ms(lambda: lops.leaf_factor(dleaf), 5)
    loop = time_ms(lambda: [lops.leaf_factor(d) for d in singles], 5)
    plain = time_ms(lambda: lref.hck_leaf_factor_ref(dleaf), 3)
    chain = time_ms(lambda: factor_chain(dleaf), 3)
    bound = bound_ms(*factor_cost(dleaf))
    say(f"[9 timing] leaf_factor stacked over G={len(LAMS)} ridges "
        f"({tuple(dleaf.shape)}): one launch {stacked:.4f} ms, "
        f"{len(LAMS)} single launches {loop:.4f} ms, "
        f"plain {plain:.4f} ms, chain torch.linalg.cholesky + "
        f"solve_triangular {chain:.4f} ms, bound {bound[0]:.4f} ms "
        f"({bound[1]})")
    records[0]["leaf_factor_stacked"] = {
        "G": len(LAMS), "ms": stacked, "single_launches_ms": loop,
        "plain_ms": plain, "library_chain_ms": chain, "bound_ms": bound[0]}
    return records


def factor_chain(dleaf):
    """B3's function as a chain of two PyTorch calls (the yardstick: no
    one call computes both L and L^-1)."""
    eye = torch.eye(dleaf.shape[-1], dtype=dleaf.dtype, device=dleaf.device)
    return torch.linalg.solve_triangular(torch.linalg.cholesky(dleaf),
                                         eye.expand_as(dleaf), upper=False)


def factor_f64(dleaf, rec) -> None:
    """Phase 9: B3 in float64 (the kernel the f64 fits of phases 5, 8b and
    8c launch), on the fit's leaves cast to f64: the first EXACT_N / LEAF
    of them (the shape of phase 5's f64 fit) and all of them, beside the
    bound (f64 flops at the CUDA-core f64 rate)."""
    from repro_torch.kernels.hck_leaf.ops import leaf_factor

    rec["f64"] = {}
    for what, d in (("exact_fit", dleaf[:EXACT_N // LEAF]), ("fit", dleaf)):
        d = d.double().contiguous()
        ms = time_ms(lambda d=d: leaf_factor(d), 10)
        bound = bound_ms(*factor_cost(d), peak_flops=PEAK_F64)
        rec["f64"][what] = {"shape": list(d.shape), "ms": ms,
                            "bound_ms": bound[0], "bound_by": bound[1]}
        say(f"[9 timing] leaf_factor f64 {tuple(d.shape)}: kernel "
            f"{ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")


def sweep_launches(plan, f):
    """The inputs of one sweep_factors pass on ``plan`` at the bandwidth of
    factors ``f``: every level's Sigma distance tile (one grouped
    gram_chol_dist launch), the leaves' (one gram_dist launch, Adiag) and
    (dist, parent Linv) of U and of every level's W (one grouped
    cross_solve_dist launch)."""
    from repro_torch.core.hck import sigma_linv

    linv = [sigma_linv(c).contiguous() for c in f.sigma_cho]
    return {
        "sigma": list(plan.lm_self), "adiag": plan.leaf_self,
        "cross": [(plan.leaf_cross, linv[-1])]
        + [(plan.lm_cross[lvl - 1], linv[lvl - 1])
           for lvl in range(1, plan.levels)],
    }


def check_gram_dist(dist, got, rtol, name="gaussian", sigma=SIGMA,
                    jitter=JITTER):
    """B8's output ``got`` (gram, factor or None; a grouped or a one-group
    launch's, or gram_dist's) against the per-level plain version on the
    same cached distances: the Gram is one epilogue per entry (rtol also
    bounds the ulp that the card's exp and torch's may differ by); the
    factor is held to the Gram-family factor bound, 1e-4 relative in
    float32 (1e-10 in float64)."""
    from repro_torch.kernels.build_stage.ref import build_gram_dist_ref

    want = build_gram_dist_ref(dist, name=name, sigma=sigma, jitter=jitter,
                               want_chol=got[1] is not None)
    sync()
    errs = [check_rel(f"gram_chol_dist[{name}] gram", got[0], want[0], rtol)]
    if got[1] is not None:
        errs.append(check_rel(f"gram_chol_dist[{name}] chol", got[1],
                              want[1], rtol))
    return max(errs), float(max((g - w).abs().max() for g, w in
                                zip(got, want) if g is not None))


def check_cross_dist(dist, linv, got, rtol, name="gaussian", sigma=SIGMA):
    """B9's output ``got`` (a grouped or a one-group launch's) against
    the per-level plain version.  U = K Linv^T Linv is amplified by
    kappa(Sigma), so, as for B2 (check_cross), the gate is the
    componentwise bound of the two products, |dU| <= 4 (2r + 1) eps
    |K| |Linv|^T |Linv|: 2r for the two length-r sums, 1 for the
    epilogue's rounding (the distances are the same cached tile on both
    sides).  In float64 also rel <= rtol (1e-10)."""
    from repro_torch.core.kernels_fn import kernel_epilogue
    from repro_torch.kernels.build_stage.ref import build_cross_dist_ref

    want = build_cross_dist_ref(dist, linv, name=name, sigma=sigma)
    sync()
    require(bool(torch.isfinite(got).all()),
            f"cross_solve_dist[{name}] finite")
    r = linv.shape[-1]
    # bfloat16 tiles: the kernel computes in float32 on the promoted tiles
    kabs = kernel_epilogue(name, sigma)(dist.to(linv.dtype)).abs()
    bound = (kabs @ linv.abs().mT) @ linv.abs()
    eps = torch.finfo(linv.dtype).eps
    err = (got - want).abs()
    require(bool((err <= 4 * (2 * r + 1) * eps * bound).all()),
            f"cross_solve_dist[{name}] |dU| <= 4 (2r + 1) eps "
            "|K||Linv^T||Linv|")
    rel = rel_max(got, want)
    if dist.dtype == torch.float64:
        require(rel <= rtol,
                f"cross_solve_dist[{name}] rel {rel:.3e} <= {rtol}")
    return rel, float(err.max())


def nll_of(inv, y_sorted):
    """Eq. 25 NLL through the structured inverse ``inv`` of (K + lam I),
    the targets in tree order."""
    from repro_torch.core import hmatrix

    alpha = hmatrix.apply_inverse(inv, y_sorted)
    n = y_sorted.shape[0]
    return (0.5 * torch.sum(y_sorted[:, 0] * alpha[:, 0])
            + 0.5 * inv.logabsdet + 0.5 * n * math.log(2 * math.pi))


def matvec_gap(fa, fb, gen) -> float:
    """The two factor sets as operators: matvec on one seeded (n, 7) block,
    max difference relative to the largest entry."""
    from repro_torch.core import hmatrix

    b = torch.randn((fa.n, N_CLASSES), generator=gen, dtype=fa.adiag.dtype,
                    device=fa.adiag.device)
    return rel_max(hmatrix.matvec(fa, b), hmatrix.matvec(fb, b))


def factors_gap(fa, fb) -> dict:
    """Max relative gaps of Sigma, its factor (over levels) and Adiag."""
    gaps = {field: max(rel_max(a, b) for a, b in zip(getattr(fa, field),
                                                      getattr(fb, field)))
            for field in ("sigma", "sigma_cho")}
    gaps["adiag"] = rel_max(fa.adiag, fb.adiag)
    return gaps


def phase_sweep(fit, dev) -> dict:
    """Phase 7: the sweep path at covtype width, counts around exactly it."""
    from repro_torch.core import gp, kpca, krr
    from repro_torch.core.hck import build_sweep_plan, sweep_factors
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.core.partition import pad_points

    x, labels, xt, yt = fit["x"], fit["labels"], fit["xt"], fit["yt"]
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    stages = {}
    timed = stage_timer(stages)
    # krr.fit's seed: the same padding, tree and landmarks as phase 3's fit
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    sizes = [1, 64, 700, 4096]
    sync()
    torch.cuda.reset_peak_memory_stats()

    # ---- the sweep path: counts set to 0 just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    xp, yp, _ = timed("pad_points", lambda: pad_points(
        x, labels, LEAF, LEVELS, generator=gen))
    plan = timed("build_sweep_plan", lambda: build_sweep_plan(
        xp, levels=LEVELS, rank=RANK, generator=gen))
    target = torch.where(yp == 0, 1.0, -1.0).to(x.dtype)   # class 0 vs all
    nll = timed("mle_grid (4 x 4)", lambda: gp.mle_grid(
        xp, target, levels=LEVELS, rank=RANK, sigmas=SIGMAS, noises=LAMS,
        jitter=JITTER, plan=plan))
    grid_launches = read_counts()[0]
    f1 = timed("sweep_factors (sigma 1)", lambda: sweep_factors(plan, ker))
    path = timed("fit_path (4 lambdas, scored)", lambda: krr.fit_path(
        xp, yp, kernel=ker, lams=LAMS, classification=True, factors=f1,
        x_val=xt, y_val=yt))
    best = timed("best() + engine", lambda: path.best())
    served = []
    for s in sizes:
        served.append(timed(f"request {s}", lambda s=s: best.predict(
            xt[:s])))
    km = timed("kpca_fit", lambda: kpca.kpca_fit(
        f1, ker, KPCA_DIM, iters=KPCA_ITERS,
        generator=torch.Generator(device=dev).manual_seed(SEED + 4)))
    emb_t = timed("kpca transform (4096)", lambda: km.transform(xt[:4096]))
    sync()
    t_path = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    sweep_shapes = matvec_shapes()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated() / 2**30

    expected = {"gram_chol": 0, "cross_solve": 0, "gram_chol_levels": 0,
                "cross_solve_levels": 0,
                "gram_chol_dist": 5, "gram_chol_dist_levels": 5,
                "cross_solve_dist": 0, "cross_solve_dist_levels": 5,
                "leaf_factor": 5,
                "leaf_solve": 4 * len(LAMS) + 3 * len(LAMS),
                "leaf_matvec": 3 * len(LAMS) + KPCA_ITERS + 2,
                "hck_leaf_project": 3, "kernel_matvec": 0, "kernel_tile": 0,
                "policy_dist": 0, "leaf_update": 0, "flash_attention": 0,
                "flash_attention_wgmma": 0, "ssd_intra_chunk": 0,
                "kernel_matvec_tc": 0, "kernel_tile_tc": 0,
                "ssd_intra_chunk_wgmma": 0,
                "policy_dist_tiled": 0, **BF16_ZERO, **PANEL_ZERO}
    got = {k: v for k, v in launches.items()
           if k not in ("oos_contract", "oos_contract_pair")}
    require(got == expected, f"sweep launches {got} == expected {expected}")
    require(launches["oos_contract"] == launches["oos_contract_pair"] > 0,
            "oos_contract on the sweep path, one launch a bucket: "
            f"{launches['oos_contract']} == {launches['oos_contract_pair']}")
    require(all(v == 0 for v in plain_calls.values()),
            f"no plain version ran on the sweep path: {plain_calls}")
    require(nll.shape == (len(SIGMAS), len(LAMS))
            and bool(torch.isfinite(nll).all()), "NLL surface finite")
    require(path.alphas.shape == (len(LAMS), LEAF << LEVELS, N_CLASSES)
            and bool(torch.isfinite(path.alphas).all()), "path alphas")
    g_best = int(torch.argmin(path.scores))
    require(best.lam == LAMS[g_best], "best() is the lowest score's lambda")
    require(all(z.shape == (s, N_CLASSES) and bool(torch.isfinite(z).all())
                for z, s in zip(served, sizes)), "served requests")
    require(emb_t.shape == (4096, KPCA_DIM)
            and bool(torch.isfinite(emb_t).all())
            and bool(torch.isfinite(km.embedding).all()), "kpca outputs")
    say(f"[7 sweep] n={LEAF << LEVELS} levels={LEVELS} r={RANK} sigmas "
        f"{SIGMAS} lambdas {LAMS}: the whole path {t_path:.3f} s (first "
        f"call), peak device memory {peak:.2f} GiB")
    say("[7 sweep] stage wall times (synchronised): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in stages.items()))
    say(f"[7 sweep] launches on the sweep path: {launches} (mle_grid alone: "
        f"{grid_launches}); plain versions called: {plain_calls}")
    say("[7 sweep] NLL surface (rows sigma, columns lambda): "
        + json.dumps([[float(v) for v in row] for row in nll]))
    say(f"[7 sweep] fit_path test error per lambda "
        f"{[round(float(v), 6) for v in path.scores]}; best lambda "
        f"{best.lam}; kpca top eigenvalues "
        f"{[round(float(v), 4) for v in km.evals]}")
    return {"plan": plan, "xp": xp, "yp": yp, "target": target, "nll": nll,
            "f1": f1, "path": path, "launches": launches,
            "matvec_shapes": sweep_shapes,
            "grid_launches": grid_launches, "stages": stages,
            "t_path": t_path, "peak": peak}


def phase_sweep_gates(fit, sw, dev) -> dict:
    """Phase 8: every gate of the sweep; each raises on a miss."""
    from repro_torch.core import gp, hmatrix, kpca, krr
    from repro_torch.core.hck import (build_hck, build_sweep_plan,
                                      landmark_indices, sweep_factors,
                                      to_dense)
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.build_stage.ops import (build_cross_dist,
                                                     build_cross_dist_levels,
                                                     build_gram_dist,
                                                     build_gram_dist_levels)
    from repro_torch.kernels.build_stage.ref import direct_dist

    res = {}
    plan, f1 = sw["plan"], sw["f1"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    # B8 and B9 at the sweep's covtype shapes, f32: every level of the
    # grouped launches (the path's) and the leaves' Adiag against the
    # per-level plain versions
    args = sweep_launches(plan, f1)
    opts = dict(sigma=SIGMA, jitter=JITTER)
    grams = build_gram_dist_levels(args["sigma"], **opts)
    adiag = build_gram_dist(args["adiag"], want_chol=False, **opts)
    errs = [check_gram_dist(d, got, 1e-4)
            for d, got in zip(args["sigma"], grams)]
    errs.append(check_gram_dist(args["adiag"], adiag, 1e-4))
    res["gram_chol_dist"] = max(e[1] for e in errs)
    say(f"[8 gates] gram_chol_dist: Sigma of all {LEVELS} levels in one "
        f"grouped launch (with chol) and Adiag "
        f"{tuple(plan.leaf_self.shape)}: rel {max(e[0] for e in errs):.3e}, "
        f"max|d| {res['gram_chol_dist']:.3e} (tolerance 1e-4 relative) ok")
    dists, linvs = zip(*args["cross"])
    us = build_cross_dist_levels(dists, linvs, sigma=SIGMA)
    errs = [check_cross_dist(d, li, u, None)
            for d, li, u in zip(dists, linvs, us)]
    res["cross_solve_dist"] = max(e[1] for e in errs)
    say(f"[8 gates] cross_solve_dist: U {tuple(plan.leaf_cross.shape)} and "
        f"W of levels 1..{LEVELS - 1} in one grouped launch (split TF32): "
        f"rel {max(e[0] for e in errs):.3e}, max|d| "
        f"{res['cross_solve_dist']:.3e} (componentwise 4 (2r + 1) eps "
        f"|K||Linv^T||Linv|) ok")

    # small shapes, f32 and f64, all three base kernels (laplace: l1 plan):
    # ragged groups (1, 2 and 3 tiles of m 24 and one of m 16; U-like
    # m 48 beside W-like m 32, one node in a group; r 16 and r 9) through
    # the grouped wrappers, and the one-group wrappers on the same inputs
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        o = dict(dtype=dtype, device=dev)
        for name in ("gaussian", "imq", "laplace"):
            metric = "l1" if name == "laplace" else "l2"
            kw = dict(name=name, sigma=SIGMA)
            pts = torch.randn((6, 24, 5), generator=gen, **o)
            p16 = torch.randn((2, 16, 5), generator=gen, **o)
            selfs = [direct_dist(p, p, metric)
                     for p in (pts[:1], pts[1:3], pts[3:], p16)]
            for d, got in zip(selfs, build_gram_dist_levels(
                    selfs, jitter=1e-3, **kw)):
                check_gram_dist(d, got, rtol, jitter=1e-3, **kw)
            for chol in (True, False):
                d = direct_dist(pts, pts, metric)
                check_gram_dist(d, build_gram_dist(
                    d, jitter=1e-3, want_chol=chol, **kw), rtol, jitter=1e-3,
                    **kw)
            a = torch.randn((7, 16, 16), generator=gen, **o)
            lis = torch.linalg.inv(torch.linalg.cholesky(
                a @ a.mT / 16 + torch.eye(16, **o)))
            linvs = [lis[:4].contiguous(), lis[4:5].contiguous(),
                     lis[5:].contiguous()]
            z = torch.randn((7, 16, 5), generator=gen, **o)
            dists = [direct_dist(torch.randn((4, 48, 5), generator=gen, **o),
                                 z[:4], metric),
                     direct_dist(torch.randn((1, 32, 5), generator=gen, **o),
                                 z[4:5], metric),
                     direct_dist(torch.randn((2, 32, 5), generator=gen, **o),
                                 z[5:], metric)]
            for d, li, u in zip(dists, linvs, build_cross_dist_levels(
                    dists, linvs, **kw)):
                check_cross_dist(d, li, u, rtol, **kw)
            check_cross_dist(dists[0], linvs[0], build_cross_dist(
                dists[0], linvs[0], **kw), rtol, **kw)
            # r = 9: Linv staged a value at a time, U stored a value at a time
            a9 = torch.randn((3, 9, 9), generator=gen, **o)
            li9 = torch.linalg.inv(torch.linalg.cholesky(
                a9 @ a9.mT / 9 + torch.eye(9, **o))).contiguous()
            d9 = direct_dist(torch.randn((3, 20, 5), generator=gen, **o),
                             torch.randn((3, 9, 5), generator=gen, **o),
                             metric)
            (u9,) = build_cross_dist_levels([d9], [li9], **kw)
            check_cross_dist(d9, li9, u9, rtol, **kw)
        say(f"[8 gates] {str(dtype)[6:]} small shapes: gram_chol_dist and "
            f"cross_solve_dist grouped over ragged levels, and one level a "
            f"launch (gram_chol_dist with and without chol), for gaussian, "
            f"imq and laplace within {rtol} ok")
    pts = torch.randn((3, 16, 5), generator=gen, device=dev)
    pts[1, 7] = pts[1, 2]
    d = direct_dist(pts, pts, "l2")
    (_, chol), = build_gram_dist_levels([d], sigma=0.1, jitter=-1e-3)
    _, chol1 = build_gram_dist(d, sigma=0.1, jitter=-1e-3)
    sync()
    for c in (chol, chol1):
        require(bool(torch.isnan(c[1]).any() and torch.isfinite(c[0]).all()),
                "gram_chol_dist: an indefinite tile gives NaN, no clamp")
    say("[8 gates] an indefinite distance tile gives NaN in gram_chol_dist "
        "(grouped and one level a launch; no pivot clamp) ok")

    # sweep_factors against build_hck: n = 4,096 in f64, full width in f32
    x64 = make_data(EXACT_N, 8, dev, torch.Generator(device=dev).manual_seed(
        SEED + 2), dtype=torch.float64)[0]
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    p64 = build_sweep_plan(x64, levels=EXACT_LEVELS, rank=RANK,
                           generator=torch.Generator(device=dev).manual_seed(7))
    fs = sweep_factors(p64, ker)
    fb = build_hck(x64, levels=EXACT_LEVELS, rank=RANK, kernel=ker,
                   generator=torch.Generator(device=dev).manual_seed(7))
    require(torch.equal(fs.tree.perm, fb.tree.perm), "same tree (n=4096)")
    gaps = factors_gap(fs, fb)
    gaps["matvec"] = matvec_gap(fs, fb, gen)
    for k, v in gaps.items():
        require(v <= 1e-10, f"n=4096 f64 sweep vs build_hck {k} {v:.3e}")
    say("[8 gates] sweep_factors vs build_hck, n=4096 f64: " + ", ".join(
        f"{k} {v:.3e}" for k, v in gaps.items()) + " (each <= 1e-10) ok")
    fw = fit["model"].factors
    require(torch.equal(f1.tree.perm, fw.tree.perm)
            and all(torch.equal(a, b) for a, b in zip(f1.landmarks,
                                                      fw.landmarks)),
            "the plan draws krr.fit's tree and landmarks")
    gaps = factors_gap(f1, fw)
    gaps["matvec"] = matvec_gap(f1, fw, gen)
    for k, v in gaps.items():
        require(v <= 1e-4, f"full-width f32 sweep vs build_hck {k} {v:.3e}")
    res["sweep_vs_build"] = gaps
    bits = {fld: max(float((a - b).abs().max()) for a, b in zip(
        getattr(f1, fld), getattr(fw, fld))) for fld in ("sigma", "sigma_cho",
                                                         "w")}
    bits.update(u=float((f1.u - fw.u).abs().max()),
                adiag=float((f1.adiag - fw.adiag).abs().max()))
    res["sweep_vs_build_abs"] = bits
    require(not any(bits.values()), f"full-width f32 sweep_factors and "
            f"build_hck bit for bit at sigma 1: {bits}")
    say("[8 gates] sweep_factors vs build_hck at sigma 1, full width f32, "
        "largest |difference| per field: " + ", ".join(
            f"{k} {v:.3e}" for k, v in bits.items()) + " (each 0: the same "
        "direct-sum distances, epilogue, blocked factor and split-TF32 "
        "products) ok")
    say("[8 gates] sweep_factors vs build_hck (krr.fit's factors), full "
        "width f32: " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + " (each <= 1e-4; U and W through matvec) ok")

    # invert_multi against invert_with_leaf, full width
    multi, lo_all = hmatrix.invert_multi_with_leaf(f1, LAMS)
    ld_gap = 0.0
    for g, lam in enumerate(LAMS):
        one, lo = hmatrix.invert_with_leaf(f1, lam)
        at = multi.at(g)
        require(torch.equal(lo_all[g], lo) and torch.equal(at.linv, one.linv),
                f"invert_multi lo and linv bit for bit at lambda {lam}")
        require(all(t.is_contiguous() for t in (at.adiag, at.u, at.linv)),
                "invert_multi slices contiguous")
        ld_gap = max(ld_gap, abs(float(at.logabsdet - one.logabsdet))
                     / abs(float(one.logabsdet)))
        del one, lo
    require(ld_gap <= 1e-6, f"invert_multi logabsdet rel {ld_gap:.3e}")
    del multi, lo_all
    say(f"[8 gates] invert_multi(f, {LAMS})[g] vs invert_with_leaf: lo and "
        f"linv identical, logabsdet rel {ld_gap:.3e} <= 1e-6 ok")

    # NLL surface at n = 4,096: f64 against the dense oracle, f32 against f64
    xs, labels_s, _, _ = make_data(EXACT_N, 8, dev, torch.Generator(
        device=dev).manual_seed(SEED + 6))
    y64 = torch.where(labels_s == 0, 1.0, -1.0).double()
    dirs = [torch.eye(D, device=dev)[(lvl + torch.arange(1 << lvl)) % D]
            for lvl in range(EXACT_LEVELS)]
    idx = [landmark_indices(1 << lvl, EXACT_N >> lvl, RANK, device=dev,
                            generator=gen) for lvl in range(EXACT_LEVELS)]
    draws = dict(directions=dirs, landmark_index=idx)
    plans = {dt: build_sweep_plan(xs.to(dt), levels=EXACT_LEVELS, rank=RANK,
                                  **draws) for dt in (torch.float64,
                                                      torch.float32)}
    surf = {dt: gp.mle_grid(xs.to(dt), y64.to(dt), levels=EXACT_LEVELS,
                            rank=RANK, sigmas=SIGMAS, noises=LAMS,
                            jitter=JITTER, plan=p)
            for dt, p in plans.items()}
    s64, s32 = surf[torch.float64], surf[torch.float32]
    eye = torch.eye(EXACT_N, dtype=torch.float64, device=dev)
    oracle = torch.empty_like(s64)
    for i, sg in enumerate(SIGMAS):
        f = sweep_factors(plans[torch.float64],
                          BaseKernel("gaussian", sg, JITTER))
        a = to_dense(f)
        ys = y64[f.tree.perm]
        for j, lam in enumerate(LAMS):
            k = a + lam * eye
            oracle[i, j] = (0.5 * ys @ torch.linalg.solve(k, ys)
                            + 0.5 * torch.linalg.slogdet(k)[1]
                            + 0.5 * EXACT_N * math.log(2 * math.pi))
    rel64 = float(((s64 - oracle).abs() / oracle.abs()).max())
    rel32 = float(((s32.double() - s64).abs() / s64.abs()).max())
    require(rel64 <= 1e-8, f"f64 NLL surface vs dense oracle {rel64:.3e}")
    require(rel32 <= 1e-4, f"f32 NLL surface vs f64 {rel32:.3e}")
    res["nll_exact"] = (rel64, rel32)
    say(f"[8 gates] NLL surface n={EXACT_N}, 4 x 4: f64 vs dense oracle "
        f"(slogdet, solve of to_dense + lam I) max rel {rel64:.3e} <= 1e-8; "
        f"f32 vs f64 max rel {rel32:.3e} <= 1e-4 ok")

    # NLL surface at full width against the naive per-point path
    # (invert_with_leaf, apply_inverse per point).  Gated, per sigma: (a)
    # the f32 surface against that path run on the sweep's own factors, at
    # the f32 noise floor eps32 ||K 1|| / ||1||; (b) the sweep's factors
    # (B8, B9 from cached distances) against build_hck's (B1, B2 from
    # points), through the NLL of both sets in f64: equal (the two factor
    # sets are equal bit for bit); (c) each row's argmin over lambda
    # against the naive path on build_hck's factors.  Printed beside them,
    # not gated: the f32 surface against that path, and each path's f32
    # NLL against its own factors' f64 NLL.
    nll, xp, y_t = sw["nll"], sw["xp"], sw["target"]
    own = torch.empty_like(nll)
    naive = torch.empty_like(nll)
    naive64 = torch.empty_like(nll, dtype=torch.float64)
    sweep64 = torch.empty_like(naive64)
    floors = []
    ones = torch.ones((xp.shape[0], 1), dtype=xp.dtype, device=dev)
    for i, sg in enumerate(SIGMAS):
        kern = BaseKernel("gaussian", sg, JITTER)
        fs = sweep_factors(plan, kern)
        f = build_hck(xp, levels=LEVELS, rank=RANK, kernel=kern,
                      generator=after_padding(fit, dev))
        ys = y_t[f.tree.perm][:, None]
        require(torch.equal(fs.tree.perm, f.tree.perm),
                f"full-width sweep and build_hck share the tree, sigma {sg}")
        pairs = ((own, fs), (naive, f), (sweep64, to_f64(fs)),
                 (naive64, to_f64(f)))
        for j, lam in enumerate(LAMS):
            for out, fac in pairs:
                inv, _ = hmatrix.invert_with_leaf(fac, lam)
                out[i, j] = nll_of(inv, ys.to(fac.u.dtype))
                del inv
        floors.append(torch.finfo(torch.float32).eps * float(
            torch.linalg.vector_norm(hmatrix.matvec(f, ones))
            / math.sqrt(xp.shape[0])))
        del f, fs, pairs
    rel = ((nll - own).abs() / own.abs()).max(dim=1).values
    rel64 = ((sweep64 - naive64).abs() / naive64.abs()).max(dim=1).values
    for i, sg in enumerate(SIGMAS):
        require(float(rel[i]) <= floors[i],
                f"full-width NLL sigma {sg}: rel {float(rel[i]):.3e} <= "
                f"floor {floors[i]:.3e}")
        require(bool(torch.equal(sweep64[i], naive64[i])),
                f"full-width NLL sigma {sg}, factors in f64: the sweep's "
                f"and build_hck's equal (rel {float(rel64[i]):.3e})")
    require(torch.equal(nll.argmin(dim=1), naive.argmin(dim=1)),
            "each row's argmin over lambda agrees with the naive path")
    res["nll_full"] = [float(v) for v in rel]
    fmt = lambda t: [float(f"{v:.3e}") for v in t.tolist()]
    to_hck = (nll - naive).abs() / naive.abs()
    err_sweep = (nll.double() - sweep64).abs() / sweep64.abs()
    err_naive = (naive.double() - naive64).abs() / naive64.abs()
    say("[8 gates] full-width NLL surface vs the naive path (invert_with_leaf,"
        " apply_inverse per point) on the sweep's own factors, max rel per "
        "sigma " + ", ".join(f"{sg}: {float(rel[i]):.3e} <= {floors[i]:.3e}"
                             for i, sg in enumerate(SIGMAS))
        + " (the f32 noise floor eps32 ||K 1|| / ||1||); the sweep's factors "
        "vs build_hck's, NLL in f64, max rel " + ", ".join(
            f"{sg}: {float(rel64[i]):.3e}" for i, sg in enumerate(SIGMAS))
        + " (equal); argmin over lambda agrees with the naive path on "
        "build_hck's factors in every row ok")
    say("[8 gates] full-width NLL, not gated, rel per lambda: the f32 "
        "surface vs the naive path on build_hck's factors " + "; ".join(
            f"{sg}: {fmt(to_hck[i])}" for i, sg in enumerate(SIGMAS))
        + "; each path's f32 NLL vs its own factors' f64 NLL, sweep / naive "
        + "; ".join(f"{sg}: {fmt(err_sweep[i])} / {fmt(err_naive[i])}"
                    for i, sg in enumerate(SIGMAS)))

    # fit_path against krr.fit at each lambda (same tree and landmarks).
    # The padding rows are near-duplicates, so K + lam I has eigenvalues
    # near lam and kappa ~ ||K|| / lam; at lam = 1e-3 that is ~5e7, above
    # 1 / eps32, and neither entry point's f32 solve reaches the f32 noise
    # floor of its residual, eps32 ||K|| ||alpha|| / ||y|| (||K|| bounded
    # below by ||K 1|| / ||1||).  f32 gates: where krr.fit's own alpha
    # reaches that floor, fit_path's alpha is within 1e-4 of it and reaches
    # the floor too; where it does not, fit_path's residual in krr.fit's
    # system is at most twice krr.fit's own.  f64 gate: the two entry points
    # in float64, alpha by alpha within 1e-4, at every lambda.
    from repro_torch.core import hmatrix as hm

    path, fw = sw["path"], fit["model"].factors
    norm = torch.linalg.vector_norm

    def residual(f, a, y, lam):
        return float(norm(y - hm.matvec(f, a) - lam * a) / norm(y))

    ys = one_vs_all(sw["yp"], torch.float32)[fw.tree.perm]
    knorm = float(norm(hm.matvec(fw, torch.ones((fw.n, 1), device=dev)))
                  / math.sqrt(fw.n))
    fit_opts = dict(kernel=ker, rank=RANK, leaf_size=LEAF,
                    classification=True)
    rows = []
    for g, lam in enumerate(LAMS):
        alpha = fit["model"].alpha if lam == LAM else krr.fit(
            fit["x"], fit["labels"], lam=lam, generator=torch.Generator(
                device=dev).manual_seed(SEED + 1), **fit_opts).alpha
        floor = (torch.finfo(torch.float32).eps * knorm
                 * float(norm(alpha) / norm(ys)))
        gap = rel_max(path.alphas[g], alpha)
        r_path = residual(fw, path.alphas[g], ys, lam)
        r_fit = residual(fw, alpha, ys, lam)
        rows.append((lam, gap, r_path, r_fit, floor))
        if r_fit <= floor:
            require(gap <= 1e-4 and r_path <= floor,
                    f"f32 fit_path vs krr.fit at lambda {lam}: {rows[-1]}")
        else:
            require(r_path <= 2 * r_fit,
                    f"f32 fit_path vs krr.fit at lambda {lam}: {rows[-1]}")
    require(int(torch.argmin(path.scores)) == LAMS.index(path.best().lam),
            "best() at the lowest score")
    x64 = fit["x"].double()
    gen64 = lambda: torch.Generator(device=dev).manual_seed(SEED + 1)
    path64 = krr.fit_path(x64, fit["labels"], lams=LAMS, generator=gen64(),
                          **fit_opts)
    f64 = path64.factors
    ys64 = one_vs_all(sw["yp"], torch.float64)[f64.tree.perm]
    rows64 = [(rel_max(path64.alphas[g], krr.fit(
        x64, fit["labels"], lam=lam, generator=gen64(), **fit_opts).alpha),
        residual(f64, path64.alphas[g], ys64, lam))
        for g, lam in enumerate(LAMS)]
    del path64, f64
    require(max(r[0] for r in rows64) <= 1e-4,
            f"f64 fit_path vs krr.fit alphas {rows64}")
    res["fit_path"] = {"f32": rows, "f64": rows64}
    say("[8 gates] fit_path vs krr.fit, full width f32, per lambda: alpha "
        "rel gap, residual ||(K + lam I) alpha - y|| / ||y|| in krr.fit's "
        "system of fit_path's alpha and of krr.fit's, the f32 floor: "
        + "; ".join(f"{lam}: {a:.3e}, {b:.3e}, {c:.3e}, {d:.3e}"
                    for lam, a, b, c, d in rows)
        + " (alpha <= 1e-4 where krr.fit reaches the floor, else residual "
        "<= 2x krr.fit's); f64: alpha rel gap and residual " + "; ".join(
            f"{lam}: {a:.3e}, {b:.3e}" for lam, (a, b) in zip(LAMS, rows64))
        + " (alpha <= 1e-4); best() picks the lowest score ok")

    # KPCA at n = 4,096 in f64 against the dense oracle
    fk = sweep_factors(plans[torch.float64], ker)
    dense = kpca.center(to_dense(fk))
    evals_all = torch.linalg.eigvalsh(dense).flip(0)
    emb_d, evals_d = kpca.kpca_embed_dense(dense, KPCA_DIM)
    q = KPCA_DIM + 4
    # subspace iteration: the top-dim Ritz subspace is off by about
    # (lam_{q+1} / lam_{dim+1})^iters / (1 - lam_{dim+1} / lam_dim); run
    # until that bound is 1e-8
    rate = float(evals_all[q] / evals_all[KPCA_DIM])
    gap = 1.0 - float(evals_all[KPCA_DIM] / evals_all[KPCA_DIM - 1])
    iters = 5000 if rate >= 1.0 or gap <= 0.0 else min(5000, math.ceil(
        math.log(1e-8 * gap) / math.log(rate)))
    km = kpca.kpca_fit(fk, ker, KPCA_DIM, iters=iters, generator=gen)
    align = float(kpca.alignment_difference(emb_d, km.embedding))
    require(align <= 1e-6, f"KPCA alignment_difference {align:.3e} <= 1e-6")
    # transform(x_i) = embedding_i (1 - jitter n0 / lambda): the training
    # rows of K_hck carry the diagonal jitter, a query's k_hck(X, x) not
    psi = km.transform(fk.x_sorted[:512])
    want = km.embedding[:512] * (1 - JITTER * LEAF / km.evals)[None]
    rel_t = rel_max(psi, want)
    require(rel_t <= 1e-6, f"KPCA transform of training points {rel_t:.3e}")
    res["kpca"] = (align, rel_t, iters)
    say(f"[8 gates] KPCA n={EXACT_N} f64 dim {KPCA_DIM}: {iters} iterations "
        f"(eigenvalue ratios lam13/lam9 {rate:.4f}, gap {gap:.3e}); "
        f"alignment_difference vs the dense oracle {align:.3e} <= 1e-6; "
        f"transform of 512 training points vs embedding (1 - jitter n0 / "
        f"lam) rel {rel_t:.3e} <= 1e-6 ok")
    return res


# ---------------------------------------------------------------------------
# Phase 8b: the exact-kernel solvers
# ---------------------------------------------------------------------------

def kernel_matvec_cost(b, m, d, k, itemsize):
    """kernel_matvec: Xc, Y and V read once, z written once; the b * m
    kernel values (kernel_flops: each point's norm once) and 2k flops per
    pair for the contraction."""
    nbytes = itemsize * (b * d + m * d + m * k + b * k)
    return nbytes, kernel_flops(b * m, b + m, d) + 2 * k * b * m


def kernel_matvec_tc_bound(b, m, d, k):
    """The least time of kernel_matvec's tensor-core route: the larger of
    its bytes (kernel_matvec_cost's), three TF32 passes over 2 (d + k)
    flops a pair at PEAK_TF32 (the function's d and k: the kernel's padding
    to multiples of 8 is work of its instruction shape, not of the
    function), and one exp2 (or rsqrt) a pair at PEAK_SFU."""
    times = {"bytes": kernel_matvec_cost(b, m, d, k, 4)[0] / PEAK_BYTES,
             "operations": max(3 * 2 * (d + k) * b * m / PEAK_TF32,
                               b * m / PEAK_SFU)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def tile_cost(n, m, d):
    """pairwise_kernel: X and Y read once, the (n, m) float32 tile written
    once; the n * m kernel values."""
    return 4 * (n * d + m * d + n * m), kernel_flops(n * m, n + m, d)


def kernel_tile_tc_bound(n, m, d):
    """The least time of pairwise_kernel's tensor-core route: the larger of
    its bytes (tile_cost's), three TF32 passes over 2d flops a pair at
    PEAK_TF32 (the function's d, not the kernel's padding), and one exp2
    (or rsqrt) a pair at PEAK_SFU."""
    times = {"bytes": tile_cost(n, m, d)[0] / PEAK_BYTES,
             "operations": max(3 * 2 * d * n * m / PEAK_TF32,
                               n * m / PEAK_SFU)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def plain_kernel_matvec(xc, y, v, name, sigma, chunk=2048):
    """The plain version over row chunks of xc (its (chunk, m) kernel tile
    bounds the memory, as ExactKernelOp's plain path does)."""
    from repro_torch.kernels.matvec_stage.ref import kernel_matvec_ref

    return torch.cat([kernel_matvec_ref(xc[i:i + chunk], y, v, name=name,
                                        sigma=sigma)
                      for i in range(0, xc.shape[0], chunk)])


def kernel_matvec_gap(got, both) -> tuple[float, float]:
    """(max |z - z_plain| / max (K |V|), max |z - z_plain|), with ``both``
    the plain version's [K V, K |V|]."""
    k = got.shape[1]
    err = float((got.double() - both[:, :k].double()).abs().max())
    return err / float(both[:, k:].abs().max()), err


def check_kernel_matvec(xc, y, v, name, rtol, sigma=SIGMA, chunk=2048):
    """B10 against its plain version: max |z - z_plain| <= rtol *
    max (K |V|), with K |V| the plain version's product with |V| (K > 0
    for the three base kernels).  The kernel that ran must be the one
    ``ops.route`` names for the dtype, base kernel and width: f32 gaussian
    and imq with d <= 64 on the tensor cores (split TF32, the norm
    identity, every launch a ``tc_launches`` one), laplace, f64 and wider
    rows on the CUDA cores (distances summed directly, none).  The plain version uses the norm identity and
    cuBLAS; rtol is the documented f32 matvec bound, 1e-4 (1e-10 in
    float64), or tighter where a caller says why.  Returns (rel, err, the
    plain [K V, K |V|], the route that ran)."""
    from repro_torch.kernels.matvec_stage import ops

    before = ops.kernel_matvec.launches, ops.kernel_matvec.tc_launches
    got = ops.kernel_matvec(xc, y, v, name=name, sigma=sigma)
    total = ops.kernel_matvec.launches - before[0]
    tc = ops.kernel_matvec.tc_launches - before[1]
    both = plain_kernel_matvec(xc, y, torch.cat([v, v.abs()], dim=1), name,
                               sigma, chunk)
    sync()
    ran = "tc" if tc else "cuda_core"
    want = ops.route(xc.dtype, name, xc.shape[1])
    require(ran == want and total > 0 and tc in (0, total),
            f"kernel_matvec[{name}] {xc.dtype}: the {want} kernel ran "
            f"({total} launches, {tc} on the tensor cores)")
    require(bool(torch.isfinite(got).all()), f"kernel_matvec[{name}] finite")
    rel, err = kernel_matvec_gap(got, both)
    require(rel <= rtol, f"kernel_matvec[{name}] [{ran}] {tuple(xc.shape)} "
            f"x {tuple(v.shape)}: rel {rel:.3e} <= {rtol}")
    return rel, err, both, ran


def check_tile(x, y, name, atol, sigma=SIGMA, chunk=4096):
    """B11 through the registry stage against its plain version: the
    values lie in (0, 1], so the gate is absolute, atol (1e-5 in float32,
    where the plain version's norm identity loses ~eps32 (|x|^2 + |y|^2)
    per squared distance).  The launch must be one, on the route that
    ``ops.route`` names (the tensor-core kernel for f32 gaussian and imq
    with d <= 64, its one launch a ``tc_launches`` one; the CUDA-core
    kernels for laplace and wider rows, none).  Where y is x the diagonal
    must lie within atol of 1.  Laplace's plain version broadcasts (chunk,
    m, d), so it goes by 256 rows.  Returns (max|d|, the route that ran)."""
    from repro_torch.kernels.kernel_tile import ops
    from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref
    from repro_torch.kernels.registry import get_impl

    before = ops.pairwise_kernel.launches, ops.pairwise_kernel.tc_launches
    got = get_impl("pairwise_kernel", "cuda")(x, y, name=name, sigma=sigma)
    total = ops.pairwise_kernel.launches - before[0]
    tc = ops.pairwise_kernel.tc_launches - before[1]
    ran = "tc" if tc else "cuda_core"
    want = ops.route(torch.float32, name, x.shape[1])
    require(ran == want and total == 1,
            f"pairwise_kernel[{name}] d {x.shape[1]}: one launch of the "
            f"{want} kernel ({total} launches, {tc} on the tensor cores)")
    step = 256 if name == "laplace" else chunk
    err = 0.0
    for i in range(0, x.shape[0], step):
        want_k = pairwise_kernel_ref(x[i:i + step], y, name=name,
                                     sigma=sigma)
        err = max(err, float((got[i:i + step] - want_k).abs().max()))
    diag = float((got.diagonal() - 1).abs().max()) if y is x else 0.0
    sync()
    require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
            f"pairwise_kernel[{name}] float32 and finite")
    require(err <= atol, f"pairwise_kernel[{name}] [{ran}] "
            f"{tuple(x.shape)} x {tuple(y.shape)}: max|d| {err:.3e} <= "
            f"{atol}")
    require(diag <= atol, f"pairwise_kernel[{name}] y is x: the diagonal "
            f"within {atol} of 1 ({diag:.3e})")
    return err, ran


def tile_path_cases(gen, dev) -> list[tuple]:
    """B11's tensor-core shapes past phase 8b's covtype width: the two
    shapes the autotune sweep's pairwise_kernel stage gives it in phase 8e
    ((256, 4) x (16, 4): one k-step, Y shorter than one tile, the TMA
    store clipped; (128, 64) x (128, 64): eight k-steps, two full boxes),
    and every other k-step count (d 7 to 48, one instance each of the
    kernel's eight), m alternately a multiple of 4 (TMA store) and not
    (the threads' store).  Points of make_data's scale, sqrt(2/d) N(0, 1).
    (what, x, y) triples."""
    def pts(n, d):
        return math.sqrt(2.0 / d) * torch.randn((n, d), generator=gen,
                                                device=dev)

    out = [("autotune default (256, 4) x (16, 4)", pts(256, 4), pts(16, 4)),
           ("autotune covtype (128, 64) x (128, 64)", pts(128, 64),
            pts(128, 64))]
    for j, d in enumerate((7, 16, 23, 32, 39, 48)):
        m = 1000 + j % 2
        out.append((f"1024 x {m}, d {d}", pts(1024, d), pts(m, d)))
    return out


def phase_solver_kernels(fit, dev) -> dict:
    """Phase 8b (a, b): B10 and B11 against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    x, xt = fit["x"], fit["xt"]
    res = {}
    v = torch.randn((N_TRAIN, N_CLASSES), generator=gen, device=dev)
    rows = []
    for name in ("gaussian", "imq", "laplace"):
        # laplace's plain version broadcasts (rows, m, d): its full-width
        # check takes 2,048 rows of Xc against all 464,809 points (rows are
        # independent in the kernel, so b changes only the grid)
        xc = x[:2048] if name == "laplace" else x
        rows.append((name, check_kernel_matvec(
            xc, x, v, name, FULL_RTOL,
            chunk=32 if name == "laplace" else 2048)))
    res["kernel_matvec"] = rows[0][1][1]
    # the CUDA-core kernel, which f32 gaussian and imq take for d > 64, on
    # the same inputs against the same plain results and gate
    from repro_torch.kernels.matvec_stage.ops import launch_kernel

    core = []
    for name, r in rows[:2]:
        z = torch.empty_like(r[2][:, :N_CLASSES])
        launch_kernel("cuda_core", x, x, v, z, name=name, sigma=SIGMA)
        rel = kernel_matvec_gap(z, r[2])[0]
        require(bool(torch.isfinite(z).all()) and rel <= FULL_RTOL,
                f"kernel_matvec[{name}] [cuda_core] at covtype width: rel "
                f"{rel:.3e} <= {FULL_RTOL}")
        core.append(f"{name} [cuda_core] rel {rel:.3e}")
        del z
    # the control: B10 with Y's ragged tail (464,809 mod 64 = 41 rows) and
    # its V rows dropped must fail the full-width gate
    from repro_torch.kernels.matvec_stage.ops import kernel_matvec

    tail = N_TRAIN % 64
    lost = kernel_matvec_gap(
        kernel_matvec(x, x[:-tail], v[:-tail], sigma=SIGMA), rows[0][1][2])[0]
    require(lost > FULL_RTOL, f"kernel_matvec without Y's {tail}-row tail: "
            f"rel {lost:.3e} > {FULL_RTOL} (the gate sees a lost tile)")
    say("[8b solvers] kernel_matvec at covtype width, Xc (464809, 54) "
        "(laplace 2048 rows) x Y (464809, 54) x V (464809, 7) f32: "
        + ", ".join(f"{n} [{r[3]}] rel {r[0]:.3e}" for n, r in rows)
        + f", on the same inputs {', '.join(core)}"
        + f" (tolerance {FULL_RTOL} of max K|V|) ok; control, gaussian with "
        f"Y's last {tail} rows dropped: rel {lost:.3e} > {FULL_RTOL}, caught")
    del rows
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        o = dict(dtype=dtype, device=dev)
        ragged = []
        for name in ("gaussian", "imq", "laplace"):
            a, b_ = (math.sqrt(2.0 / 55) * torch.randn(s, generator=gen, **o)
                     for s in ((4097, 55), (3001, 55)))
            r = check_kernel_matvec(a, b_, torch.randn(
                (3001, 7), generator=gen, **o), name, rtol, chunk=256)
            ragged.append(f"{name} [{r[3]}] rel {r[0]:.3e}")
        say(f"[8b solvers] kernel_matvec ragged b 4097, m 3001, d 55 (the "
            f"tensor-core kernel pads it to 56), k 7 {str(dtype)[6:]}: "
            f"{', '.join(ragged)}; within {rtol} ok")
    wide = []
    xs = x[:16384]
    for k in (1, 16, 160):
        vk = torch.randn((xs.shape[0], k), generator=gen, device=dev)
        for name in ("gaussian", "imq", "laplace"):
            r = check_kernel_matvec(xs, xs, vk, name, 1e-4,
                                    chunk=128 if name == "laplace" else 2048)
            wide.append(f"k {k} {name} [{r[3]}] rel {r[0]:.3e}")
    say(f"[8b solvers] kernel_matvec n 16384, d 54, f32: {', '.join(wide)} "
        f"(tolerance 1e-4) ok")
    # rows wider than the tensor-core kernel keeps resident: f32 gaussian
    # and imq go to the CUDA-core kernel
    a, b_ = (math.sqrt(2.0 / 90) * torch.randn((n, 90), generator=gen,
                                               device=dev)
             for n in (16384, 16384))
    v90 = torch.randn((16384, N_CLASSES), generator=gen, device=dev)
    d90 = [check_kernel_matvec(a, b_, v90, name, 1e-4)
           for name in ("gaussian", "imq")]
    say(f"[8b solvers] kernel_matvec n 16384, d 90, k {N_CLASSES} f32: "
        + ", ".join(f"{n} [{r[3]}] rel {r[0]:.3e}"
                    for n, r in zip(("gaussian", "imq"), d90))
        + " (tolerance 1e-4) ok")
    del a, b_, v90, d90
    x64 = x[:2048].double()
    v64 = torch.randn((2048, 3), generator=gen, dtype=torch.float64,
                      device=dev)
    f64 = [check_kernel_matvec(x64, x64, v64, name, 1e-10, chunk=256)
           for name in ("gaussian", "imq", "laplace")]
    say(f"[8b solvers] kernel_matvec n 2048, d 54, k 3 f64, three kernels "
        f"[{', '.join(sorted({r[3] for r in f64}))}]: max rel "
        f"{max(r[0] for r in f64):.3e} (tolerance 1e-10) ok")

    from repro_torch.kernels.kernel_tile import ops as tile_ops

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles, lines, ksteps = [], [], {}
    a90, b90 = (math.sqrt(2.0 / 90) * torch.randn((2048, 90), generator=gen,
                                                  device=dev)
                for _ in range(2))
    xs = x[:4096]
    for name in ("gaussian", "imq", "laplace"):
        a, b_ = (math.sqrt(2.0 / 55) * torch.randn(s, generator=gen,
                                                   device=dev)
                 for s in ((4097, 55), (3001, 55)))
        cases = [("16384 x 16384, d 54", x[:16384], xt[:16384]),
                 ("ragged 4097 x 3001, d 55", a, b_),
                 ("ragged 4097 x 3000, d 55", a, b_[:3000]),
                 ("y is x, 4096, d 54", xs, xs),
                 ("2048 x 2048, d 90", a90, b90)]
        if name != "laplace":
            cases += tile_path_cases(gen, dev)
        for what, u, w in cases:
            err, ran = check_tile(u, w, name, 1e-5)
            tiles.append(err)
            store = ""
            if ran == "tc":   # which store the tile took
                plan = tile_ops.tc_plan(u.shape[0], w.shape[0], u.shape[1],
                                        sms)
                ksteps.setdefault(name, set()).add(plan["dp"] // 8)
                tma = plan["tma_out"]
                require(bool(tma) == (w.shape[0] % 4 == 0),
                        f"pairwise_kernel {what}: TMA store iff m % 4 == 0")
                store = ", TMA store" if tma else ", threads' store"
            elif name != "laplace" or u.shape[1] > 64:
                require(tile_ops.core_kernel(u.shape[1]) == "pair_tile",
                        f"pairwise_kernel {what}: pair_tile past d 64")
            lines.append(f"{name} {what} [{ran}{store}] {err:.2e}")
    res["kernel_tile"] = max(tiles)
    require(all(ksteps.get(k) == set(range(1, 9)) for k in ("gaussian",
                                                            "imq")),
            f"pairwise_kernel: all 16 tensor-core instances checked: "
            f"{ksteps}")
    say(f"[8b solvers] pairwise_kernel (registry stage), f32, each check "
        f"one launch on the route its dtype, base kernel and d name: "
        f"{'; '.join(lines)}; max|d| {res['kernel_tile']:.3e} (tolerance "
        f"1e-5 absolute; y is x: the diagonal within 1e-5 of 1); the tc "
        f"instances checked, by k-steps: {ksteps} ok")
    return res


def phase_bench_cg(dev) -> dict:
    """Phase 8b (c): bench_cg.py's shape in f64 against the dense solve,
    the launch counts read around every solver call."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.core.partition import auto_levels
    from repro_torch.solvers import ExactKernelOp, eigenpro_solve

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    x = torch.randn((CG_N, CG_D), generator=gen, dtype=torch.float64,
                    device=dev)
    y = torch.sin(x[:, 0]) + 0.25 * torch.cos(2.0 * x[:, 1])
    ker = BaseKernel("gaussian", CG_SIGMA, CG_JITTER)
    opts = dict(kernel=ker, lam=LAM, rank=RANK)
    eye = torch.eye(CG_N, dtype=torch.float64, device=dev)
    want = torch.linalg.solve(ker.gram(x) + LAM * eye, y[:, None])
    # the preconditioner's floor-rule tree: 32 leaves of 128, no padding
    levels = max(1, auto_levels(CG_N, RANK))

    def fit_counted(tol, pre):
        model, launches, plain_calls = counted(lambda: krr.fit_exact(
            x, y, tol=tol, maxiter=3000, precondition=pre, **opts))
        it = model.result.iterations
        expected = {"kernel_matvec": it + 1}
        if pre:
            expected.update(gram_chol=1, gram_chol_levels=1,
                            cross_solve_levels=1, leaf_factor=1,
                            leaf_solve=it + 1)
        require_launches(f"fit_exact (tol {tol}, precondition={pre})",
                         launches, plain_calls, expected)
        return model, {k: v for k, v in launches.items() if v}

    t = time.perf_counter()
    model, fit_launches = fit_counted(1e-9, True)
    t_fit = time.perf_counter() - t
    gap = float((model.alpha - want).abs().max())
    require(model.result.converged and gap < 1e-6,
            f"f64 fit_exact vs dense solve max abs {gap:.3e} < 1e-6")
    q = x[:33]
    pgap = float((model.predict(q) - (ker.cross(q, x) @ want)[:, 0])
                 .abs().max())
    require(pgap < 1e-6, f"ExactKRR.predict vs dense cross {pgap:.3e}")
    its, its_launches = {}, {}
    for pre in (True, False):
        m, its_launches[pre] = fit_counted(1e-6, pre)
        require(m.result.converged, f"fit_exact precondition={pre} converged")
        its[pre] = m.result.iterations
    require(its[True] <= its[False],
            f"preconditioned CG {its[True]} <= plain {its[False]} iterations")
    op = ExactKernelOp(x, ker)
    t = time.perf_counter()
    ep, ep_launches, ep_plain = counted(lambda: eigenpro_solve(
        op, y[:, None], ridge=LAM, n_components=160, subsample=2048,
        tol=1e-8, maxiter=3000,
        generator=torch.Generator(device=dev).manual_seed(9)))
    t_ep = time.perf_counter() - t
    # the Nystrom extension and the Rayleigh-Ritz matvec, then one apply
    # per Richardson step
    require_launches("eigenpro_solve", ep_launches, ep_plain,
                     {"kernel_matvec": ep.iterations + 2})
    egap = float((ep.x - want).abs().max())
    require(ep.converged and egap < 1e-5,
            f"EigenPro vs dense solve max abs {egap:.3e} < 1e-5")
    say(f"[8b solvers] bench_cg shape n={CG_N} d={CG_D} gaussian sigma "
        f"{CG_SIGMA} jitter {CG_JITTER} lam {LAM} rank {RANK} f64: fit_exact "
        f"(tol 1e-9) {model.result.iterations} iterations in {t_fit:.3f} s, "
        f"max|alpha - dense| {gap:.3e} < 1e-6, predict {pgap:.3e} < 1e-6 ok; "
        f"launches {fit_launches}, no plain version")
    say(f"[8b solvers] CG iterations to tol 1e-6: preconditioned "
        f"{its[True]}, plain {its[False]}, ratio "
        f"{its[False] / max(its[True], 1):.2f} (gate: preconditioned <= "
        f"plain) ok; launches preconditioned {its_launches[True]}, plain "
        f"{its_launches[False]}, no plain version")
    say(f"[8b solvers] eigenpro_solve (subsample 2048, 160 components, tol "
        f"1e-8): {ep.iterations} iterations in {t_ep:.3f} s, max|x - dense| "
        f"{egap:.3e} < 1e-5 ok; launches "
        f"{ {k: v for k, v in ep_launches.items() if v} } "
        f"(iterations + 2), no plain version")
    return {"iters": its, "eigenpro_iters": ep.iterations}


def phase_exact_krr(fit, dev) -> dict:
    """Phase 8b (d): exact-kernel KRR at covtype width, nothing cut, through
    ``krr.fit_exact`` twice: with the HCK preconditioner (B1-B4 and B10)
    and without it (B10 alone), the counts read around exactly each call.

    On this data CG preconditioned by the HCK inverse does not reach 1e-2
    within 30 iterations, while plain CG does in about 20: at d = 54 the
    preconditioned operator's spectrum is wider than the bulk of K's (in
    float64 on the CPU, in the reference as in the port:
    tests/test_torch_precond.py, ROADMAP C6).  So convergence and the
    residual through B10 are gated on the plain run, and printed for the
    preconditioned one, whose launches are gated."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.solvers import ExactKernelOp

    x, labels, xt, yt = fit["x"], fit["labels"], fit["xt"], fit["yt"]
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    opts = dict(kernel=ker, lam=LAM, rank=RANK, classification=True,
                tol=EXACT_TOL, maxiter=EXACT_MAXITER)
    # levels=12: the floor rule would give 11 levels and 227-point leaves,
    # whose Adiag tile needs more shared memory than B1 has (gram_smem(227,
    # 4) = 236,988 > 232,448 B), so B1 would raise; 12 levels give 128-point
    # leaves over 524,288 rows, 59,479 of them duplicates
    draws = {True: dict(levels=LEVELS), False: {}}
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 10)
    targets = one_vs_all(labels, x.dtype)
    op = ExactKernelOp(x, ker)
    norm = torch.linalg.vector_norm
    runs = {}
    sync()
    torch.cuda.reset_peak_memory_stats()
    for pre in (True, False):
        # ---- the exact-KRR path: counts set to 0 just before, read just
        # after ----
        t0 = time.perf_counter()
        model, launches, plain_calls = counted(lambda: krr.fit_exact(
            x, labels, generator=gen(), precondition=pre, **draws[pre],
            **opts))
        t_fit = time.perf_counter() - t0
        # ------------------------------------------------------------------
        res = model.result
        it = res.iterations
        # f32 gaussian: every B10 launch on the tensor-core kernel
        expected = {"kernel_matvec": it + 1, "kernel_matvec_tc": it + 1}
        if pre:
            expected.update(gram_chol=1, gram_chol_levels=1,
                            cross_solve_levels=1, leaf_factor=1,
                            leaf_solve=it + 1)
        require_launches(f"the exact-KRR path (precondition={pre})",
                         launches, plain_calls, expected)
        require(bool(torch.isfinite(model.alpha).all()), "alpha finite")
        # the final residual recomputed through B10 (the operator's matvec)
        resid = targets - op.matvec(model.alpha) - LAM * model.alpha
        rres = float((norm(resid, dim=0) / norm(targets, dim=0)).max())
        runs[pre] = dict(model=model, launches=launches, t_fit=t_fit,
                         resid=rres, trace=[float(v) for v in
                                            res.residuals[:it + 1]])
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain = runs[False]
    model = plain["model"]
    require(model.result.converged, f"plain CG converged to {EXACT_TOL} "
            f"within {EXACT_MAXITER}: trace {plain['trace']}")
    require(plain["resid"] <= EXACT_TOL, f"exact-KRR residual through "
            f"kernel_matvec {plain['resid']:.3e} <= {EXACT_TOL}")

    stages = {}
    timed = stage_timer(stages)
    timed("preconditioner build", lambda: krr._hck_preconditioner(
        x, kernel=ker, lam=LAM, rank=RANK, leaf_size=None, levels=LEVELS,
        method="rp", solve_config=None, generator=gen()))
    pred = timed("predict (116,203 queries)", lambda: model.predict(xt))
    require(pred.shape == (N_TEST, N_CLASSES)
            and bool(torch.isfinite(pred).all()), "exact-KRR predictions")
    acc = float((model.predict_class(xt) == yt).double().mean())
    gap = rel_max(fit["model"].predict(xt), pred)
    pc = runs[True]
    pc_it = pc["model"].result.iterations
    cg_pc = pc["t_fit"] - stages["preconditioner build"]
    per_plain = plain["t_fit"] / (model.result.iterations + 1)
    for tag, r in (("HCK-preconditioned", pc), ("plain", plain)):
        m = r["model"]
        say(f"[8b solvers] fit_exact {tag} at covtype width n={N_TRAIN} d={D} "
            f"k={N_CLASSES} gaussian sigma {SIGMA} jitter {JITTER} lam {LAM} "
            f"f32 tol {EXACT_TOL} maxiter {EXACT_MAXITER}: "
            f"{m.result.iterations} iterations, converged "
            f"{m.result.converged}, {r['t_fit']:.3f} s; residual through "
            f"kernel_matvec {r['resid']:.3e}; trace {r['trace']}")
        say(f"[8b solvers] launches on the exact-KRR path ({tag}): "
            f"{r['launches']}")
    say(f"[8b solvers] plain CG converged in {model.result.iterations} "
        f"iterations, residual {plain['resid']:.3e} <= {EXACT_TOL} ok; "
        f"peak device memory {peak:.2f} GiB")
    say("[8b solvers] stage wall times (warm, synchronised): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in stages.items())
        + f"; CG per operator apply: plain {per_plain * 1e3:.2f} ms, "
        f"preconditioned {cg_pc / (pc_it + 1) * 1e3:.2f} ms (its run less "
        f"the build)")
    say(f"[8b solvers] not gated: test accuracy {acc:.4f} over {N_TEST} "
        f"queries; max |HCK - exact| / max |exact| predictions {gap:.3e}; "
        f"HCK-preconditioned CG (levels {LEVELS}, "
        f"{(RANK << LEVELS) - N_TRAIN} duplicated rows) "
        f"{pc_it} iterations, converged {pc['model'].result.converged}")
    return {"launches": pc["launches"], "plain_launches": plain["launches"],
            "stages": stages, "peak": peak, "alpha": model.alpha,
            "iterations": {"preconditioned": pc_it,
                           "plain": model.result.iterations},
            "plain_wall_s": plain["t_fit"], "plain_s_per_apply": per_plain}


def phase_slq(sw, dev) -> dict:
    """Phase 8b (e): gp.mle_grid(logdet="slq") at covtype width against the
    exact surface, and the SLQ logdet in f64 at n = 4,096."""
    from repro_torch.core import gp, hmatrix
    from repro_torch.core.hck import sweep_factors
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.solvers.slq import rademacher_probes

    xp, y_t, plan, exact = sw["xp"], sw["target"], sw["plan"], sw["nll"]
    n = xp.shape[0]
    probes = rademacher_probes(SLQ_PROBES, n, dtype=xp.dtype, device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(42))
    kw = dict(levels=LEVELS, rank=RANK, sigmas=SIGMAS, noises=LAMS,
              jitter=JITTER, plan=plan, logdet="slq", slq_iters=SLQ_ITERS,
              cg_tol=SLQ_CG_TOL)
    sync()
    t = time.perf_counter()
    # ---- the SLQ surface: counts set to 0 just before, read just after ----
    with warnings.catch_warnings(record=True) as missed:
        warnings.simplefilter("always")
        surf, launches, plain_calls = counted(
            lambda: gp.mle_grid(xp, y_t, slq_probe_vectors=probes, **kw))
    slq_shapes = matvec_shapes()
    # -----------------------------------------------------------------------
    t_slq = time.perf_counter() - t
    # per sigma: sweep_factors (B8 grouped over the levels and the leaves,
    # B9 grouped over U and the levels),
    # one inversion at the reference ridge (B3), a B5 matvec per Lanczos
    # step, and per PCG iteration (and its start) one B5 matvec and one B4
    # preconditioner apply
    n_s, lanczos = len(SIGMAS), len(SIGMAS) * SLQ_PROBES * SLQ_ITERS
    pcg_applies = launches["leaf_solve"]
    require(pcg_applies >= n_s * len(LAMS), f"SLQ surface launches: at "
            f"least one PCG apply per grid point, read {pcg_applies}")
    require_launches("the SLQ surface", launches, plain_calls, dict(
        gram_chol_dist=n_s, gram_chol_dist_levels=n_s,
        cross_solve_dist_levels=n_s,
        leaf_factor=n_s, leaf_solve=pcg_applies,
        leaf_matvec=lanczos + pcg_applies))
    t = time.perf_counter()
    gp.mle_grid(xp, y_t, levels=LEVELS, rank=RANK, sigmas=SIGMAS,
                noises=LAMS, jitter=JITTER, plan=plan)
    sync()
    t_exact = time.perf_counter() - t
    require(surf.shape == exact.shape and bool(torch.isfinite(surf).all()),
            "SLQ surface finite")
    # the quadratic terms against the exact path's, per sigma
    y_sorted = y_t[plan.tree.perm][:, None]
    ridge0 = math.exp(sum(math.log(v) for v in LAMS) / len(LAMS))
    const = 0.5 * n * math.log(2 * math.pi)
    qgaps, rows = [], []
    for i, sg in enumerate(SIGMAS):
        f = sweep_factors(plan, BaseKernel("gaussian", sg, JITTER))
        quads, lds = gp.slq_row(f, y_sorted, LAMS, probe_vectors=probes,
                                iters=SLQ_ITERS, ridge0=ridge0,
                                cg_tol=SLQ_CG_TOL, cg_maxiter=200)
        rows.append(rel_max(0.5 * quads + 0.5 * lds + const, surf[i]))
        invs = hmatrix.invert_multi(f, LAMS)
        for g, lam in enumerate(LAMS):
            q_exact = float(y_sorted[:, 0] @ hmatrix.apply_inverse(
                invs.at(g), y_sorted)[:, 0])
            qgap = abs(float(quads[g]) - q_exact) / abs(q_exact)
            qgaps.append((sg, lam, qgap))
            if lam >= 1e-2:
                require(qgap <= SLQ_CG_TOL, f"SLQ quadratic term sigma {sg} "
                        f"lam {lam}: rel {qgap:.3e} <= {SLQ_CG_TOL}")
        del invs, f
    require(max(rows) <= 1e-6, f"mle_grid rows vs slq_row {max(rows):.3e}")
    gap = ((surf - exact).abs() / n)
    same_argmin = bool(torch.equal(surf.argmin(dim=1), exact.argmin(dim=1)))
    say(f"[8b solvers] mle_grid(logdet='slq') 4 x 4 at covtype width, "
        f"{SLQ_PROBES} probes x {SLQ_ITERS} steps, cg_tol {SLQ_CG_TOL}: "
        f"{t_slq:.3f} s against the exact surface's {t_exact:.3f} s; NLL gap "
        f"per point max {float(gap.max()):.3e} (at lam >= 1e-2 "
        f"{float(gap[:, 1:].max()):.3e}); argmin over lambda the same in "
        f"every row: {same_argmin}; surface rows vs 0.5 q + 0.5 logdet rel "
        f"{max(rows):.3e}")
    say(f"[8b solvers] launches on the SLQ surface: "
        f"{ {k: v for k, v in launches.items() if v} } ({lanczos} Lanczos "
        f"matvecs, {pcg_applies} PCG applies in {n_s * len(LAMS)} solves), "
        f"no plain version; PCG warnings {len(missed)}")
    say("[8b solvers] NLL gap per point |slq - exact| / n (rows sigma, "
        "columns lambda): " + json.dumps([[float(v) for v in row]
                                          for row in gap]))
    say("[8b solvers] quadratic terms rel gap to the exact path (sigma, lam, "
        "gap): " + "; ".join(f"{s}, {l}, {q:.2e}" for s, l, q in qgaps)
        + f" (gated <= {SLQ_CG_TOL} at lam >= 1e-2; at 1e-3 the f32 exact "
        "path is not trusted) ok")

    slq64 = slq_f64_gate(dev)
    return {"t_slq": t_slq, "t_exact": t_exact, "launches": launches,
            "matvec_shapes": slq_shapes,
            "gap": float(gap.max()), "same_argmin": same_argmin, **slq64}


def slq_f64_gate(dev) -> dict:
    """Phase 8b (e), f64 at n = 4,096: ``slq_logdet`` on the HCK matvec over
    the 4 x 4 grid against ``invert(...).logabsdet``, its error taken
    apart.  SLQ - logdet = (SLQ - H) + (H - logdet), with H = mean_p z_p^T
    log(A + lam I) z_p the Hutchinson estimate of the same probes (dense,
    from one eigh per sigma):

    * quadrature, SLQ - H, is the code's: Gauss quadrature of log, whose
      even derivatives are negative, overestimates each probe's form, so
      0 <= (SLQ - H) / n <= SLQ_QUAD_LIMIT for every draw (less 1e-9 of
      round-off, which reads 3e-13); a Lanczos
      without reorthogonalisation (the control, one draw) must exceed it;
    * the draw, H - logdet, is the probes': unbiased, with variance
      2 sum_{i != j} log(A)_ij^2 / P over P probes.  Each SLQ draw's error
      is printed in units of its std; over those draws and SLQ_MORE_DRAWS
      more (dense only) the mean error of all their probes is gated at
      SLQ_STD_LIMIT of its std, and probes of {0, 1} in place of +-1 (the
      control) must fail it."""
    from repro_torch.core import hmatrix
    from repro_torch.core.hck import build_sweep_plan, sweep_factors, to_dense
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.solvers import HCKOp, slq_logdet
    from repro_torch.solvers.slq import rademacher_probes

    n = EXACT_N
    xs = make_data(n, 8, dev, torch.Generator(device=dev).manual_seed(
        SEED + 6), dtype=torch.float64)[0]
    plan = build_sweep_plan(xs, levels=EXACT_LEVELS, rank=RANK,
                            generator=torch.Generator(device=dev)
                            .manual_seed(7))
    draws = [rademacher_probes(SLQ_PROBES, n, dtype=torch.float64,
                               device=dev, generator=torch.Generator(
                                   device=dev).manual_seed(seed))
             for seed in SLQ_DRAWS + tuple(range(1000, 1000 + SLQ_MORE_DRAWS))]
    z_all = torch.cat(draws)                                   # (P, n)
    draws = draws[:len(SLQ_DRAWS)]
    # no reorthogonalisation: every vector-valued inner product (the
    # reorthogonalisation coefficients) reads as 0
    no_reorth = lambda s: s if s.ndim == 0 else torch.zeros_like(s)
    lams = torch.tensor(LAMS, dtype=torch.float64, device=dev)
    quad, quad_ctrl, units, pooled, pooled_ctrl, spread = ([], [], [], [],
                                                          [], [])
    for sg in SIGMAS:
        f = sweep_factors(plan, BaseKernel("gaussian", sg, JITTER))
        mv = HCKOp(f).matvec
        want = torch.tensor([float(hmatrix.invert(f, lam).logabsdet)
                             for lam in LAMS], dtype=torch.float64)
        w, vecs = torch.linalg.eigh(to_dense(f))
        logs = torch.log(w[None, :] + lams[:, None])          # (G, n)
        # sum_{i != j} log(A)_ij^2 = ||log A||_F^2 - sum_i log(A)_ii^2
        diag = logs @ (vecs ** 2).T                            # (G, n)
        off = (logs ** 2).sum(1) - (diag ** 2).sum(1)
        for i, z in enumerate(draws):
            got = slq_logdet(mv, n, ridges=LAMS, iters=SLQ_ITERS,
                             probe_vectors=z).cpu()
            h = (((z @ vecs) ** 2) @ logs.T).mean(0).cpu()     # (G,)
            quad.append(((got - h) / n).tolist())
            units.append(((h - want) / torch.sqrt(2 * off.cpu() / SLQ_PROBES))
                         .tolist())
            if i == 0:
                ctrl = slq_logdet(mv, n, ridges=LAMS, iters=SLQ_ITERS,
                                  probe_vectors=z, all_reduce=no_reorth)
                quad_ctrl.append(((ctrl.cpu() - h) / n).tolist())
        # every draw's probes, densely: per-probe errors in units of the
        # one-probe std, then per draw and all together
        std1 = torch.sqrt(2 * off.cpu())
        per = ((((z_all @ vecs) ** 2) @ logs.T).cpu() - want) / std1
        by_draw = per.reshape(-1, SLQ_PROBES, len(LAMS)).mean(1)
        by_draw = by_draw * math.sqrt(SLQ_PROBES)
        at = by_draw[:, LAMS.index(1e-2)]
        spread.append((float(at.mean()), float(at.std()), float(at.min()),
                       float(at.max())))
        probes = z_all.shape[0]
        pooled.append((per.mean(0) * math.sqrt(probes)).tolist())
        h01 = (((0.5 * (z_all + 1.0)) @ vecs) ** 2 @ logs.T).cpu()
        pooled_ctrl.append(float(((h01 - want) / std1).mean(0).abs().min()
                                 * math.sqrt(probes)))
        del f, w, vecs
    q_lo = min(min(r) for r in quad)
    q_hi = max(max(r) for r in quad)
    c_hi = max(max(r) for r in quad_ctrl)
    p_hi = max(abs(v) for r in pooled for v in r)
    p_ctrl = min(pooled_ctrl)
    require(q_lo >= -1e-9 and q_hi <= SLQ_QUAD_LIMIT, f"f64 SLQ quadrature "
            f"error per point in [{q_lo:.3e}, {q_hi:.3e}] within [-1e-9, "
            f"{SLQ_QUAD_LIMIT}]")
    require(c_hi > SLQ_QUAD_LIMIT, f"control: Lanczos without "
            f"reorthogonalisation, quadrature error per point {c_hi:.3e} > "
            f"{SLQ_QUAD_LIMIT}")
    require(p_hi <= SLQ_STD_LIMIT, f"f64 SLQ probe draws: |H - logdet| over "
            f"{probes} probes {p_hi:.2f} <= {SLQ_STD_LIMIT} std")
    require(p_ctrl > SLQ_STD_LIMIT, f"control: probes of {{0, 1}}, |H - "
            f"logdet| {p_ctrl:.2f} > {SLQ_STD_LIMIT} std")
    nd = len(draws)
    say(f"[8b solvers] f64 SLQ logdet at n={n} ({SLQ_PROBES} probes x "
        f"{SLQ_ITERS} steps, draws seeded {SLQ_DRAWS}): quadrature error "
        f"(SLQ - H) / n per point in [{q_lo:.3e}, {q_hi:.3e}] (gate [-1e-9 "
        f"of round-off, {SLQ_QUAD_LIMIT}]) ok; control without "
        f"reorthogonalisation, first draw: max {c_hi:.3e} > "
        f"{SLQ_QUAD_LIMIT}, caught; |H - logdet| over the {probes} probes "
        f"of {probes // SLQ_PROBES} draws max "
        f"{p_hi:.2f} std (gate {SLQ_STD_LIMIT}) ok; control, probes of "
        f"{{0, 1}}: min {p_ctrl:.1f} std, caught")
    say("[8b solvers] f64 SLQ probe draws, (H - logdet) / std of each of "
        f"the {probes // SLQ_PROBES} draws per sigma (mean, std, min, max "
        "at lam 1e-2): " + "; ".join(
            f"{sg}: {a:+.3f}, {b:.3f}, {c:+.2f}, {d:+.2f}" for sg, (a, b, c, d)
            in zip(SIGMAS, spread)))
    say("[8b solvers] f64 SLQ per (sigma, lam): quadrature (SLQ - H) / n of "
        "each SLQ draw, the control's, each SLQ draw's (H - logdet) / std "
        f"and all {probes} probes' together: " + "; ".join(
            f"{sg}, {lam}: q " + " ".join(
                f"{quad[si * nd + d][g]:.2e}" for d in range(nd))
            + f" ctrl {quad_ctrl[si][g]:.2e} e " + " ".join(
                f"{units[si * nd + d][g]:+.2f}" for d in range(nd))
            + f" all {pooled[si][g]:+.2f}"
            for si, sg in enumerate(SIGMAS) for g, lam in enumerate(LAMS)))
    return {"quad": q_hi, "quad_ctrl": c_hi, "draw_std": p_hi}


def solver_timing(ex, kres, tune) -> list[dict]:
    """Phase 9, exact solvers: B10 at the exact-KRR path's shape (its
    tensor-core kernel, which the path takes, and the CUDA-core kernel,
    which laplace and f64 keep, on the same inputs in turns) and B11 at
    16,384 x 16,384 (:func:`tile_timing`), beside their bounds and plain
    times.  B10's bound is its route's (kernel_matvec_tc_bound), beside the
    f32 CUDA-core bound of its first design; its record carries the
    plain-CG exact-KRR fit's wall time, iterations and seconds per
    operator apply."""
    from repro_torch.kernels.matvec_stage.ops import (kernel_matvec,
                                                      launch_kernel)

    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    x, alpha = ex["x"], ex["alpha"]
    n = x.shape[0]
    z = torch.empty_like(alpha)
    core = lambda: launch_kernel("cuda_core", x, x, alpha, z,
                                 name="gaussian", sigma=SIGMA)
    turns = [time_ms(fn, 2, warmup=1) for fn in (
        lambda: kernel_matvec(x, x, alpha, sigma=SIGMA), core, core,
        lambda: kernel_matvec(x, x, alpha, sigma=SIGMA))]
    # the plain version ran at this shape in phase 8b (a): warm already
    plain = time_ms(lambda: plain_kernel_matvec(x, x, alpha, "gaussian",
                                                SIGMA), 1, warmup=0)
    records = [kernel_record(
        "kernel_matvec", src + "kernel_matvec.cu",
        tpu + "matvec_stage/matvec_stage.py:70", ex["launches"]
        ["kernel_matvec"], kres["kernel_matvec"], (turns[0] + turns[3]) / 2,
        plain, kernel_matvec_tc_bound(n, n, D, N_CLASSES),
        unit=f"one launch: exact K ({n} x {n}, d {D}) times ({n}, "
             f"{N_CLASSES})",
        kernel="split TF32 (TMA, wgmma, warp-specialised)",
        tc_launches=ex["launches"]["kernel_matvec_tc"],
        launches_plain_cg=ex["plain_launches"]["kernel_matvec"],
        bound_f32_ms=bound_ms(*kernel_matvec_cost(n, n, D, N_CLASSES, 4))[0],
        previous_ms=(turns[1] + turns[2]) / 2,
        previous="CUDA cores (kernel_matvec_f32)",
        turns_ms={"tc": [turns[0], turns[3]],
                  "cuda_core": [turns[1], turns[2]]},
        exact_krr={"wall_s": ex["plain_wall_s"],
                   "iterations": ex["iterations"]["plain"],
                   "s_per_apply": ex["plain_s_per_apply"]})]
    rec = records[0]
    say(f"[9 timing] kernel_matvec in turns (tc, cuda_core, cuda_core, tc): "
        f"{', '.join(f'{t:.3f}' for t in turns)} ms; tc {rec['ms']:.3f} ms "
        f"against CUDA cores {rec['previous_ms']:.3f} ms "
        f"({rec['previous_ms'] / rec['ms']:.2f}x); bound of the tc route "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), of f32 CUDA cores "
        f"{rec['bound_f32_ms']:.3f} ms; launches on the HCK-preconditioned "
        f"path {rec['launches']} ({rec['tc_launches']} tc); plain-CG "
        f"fit_exact {ex['plain_wall_s']:.3f} s, "
        f"{ex['iterations']['plain']} iterations, "
        f"{ex['plain_s_per_apply']:.3f} s an apply")
    records.append(tile_timing(x[:16384], ex["xt"][:16384], kres,
                               tune))
    for rec in records:
        chain = (f", chain {rec['library_chain']} "
                 f"{rec['library_chain_ms']:.4f} ms"
                 if "library_chain_ms" in rec else "")
        say(f"[9 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']} ms{chain}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), launches {rec['launches']}")
    return records


def tile_timing(xs, ys, kres, tune) -> dict:
    """Phase 9, B11 at 16,384 x 16,384, d 54, f32: its tensor-core kernel
    ("tc", gaussian's route) in turns with gaussian's CUDA-core kernel, the
    first design ("pair_tile"; gaussian's route past d 64) (tc, pair_tile,
    pair_tile, tc); laplace on its route ("tiled", B12's register-tiled
    form with the epilogue) in turns with "pair_tile".  By device
    time (device_ms: each wrapper's staging and launch queued behind a
    spin kernel), since events around the "tc" wrapper's calls read its
    host time on a slow host.  Each beside the tc route's bound
    (kernel_tile_tc_bound) and the f32 CUDA-core bound; the plain version;
    the chain torch.cdist -> square -> scale -> exp (a yardstick the port
    never calls, not one library call); the launches on the autotune path
    (phase 8e)."""
    from repro_torch.kernels.kernel_tile.ops import launch_kernel
    from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref

    n, m = xs.shape[0], ys.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=xs.device)

    def run(kind, name):
        return lambda: launch_kernel(kind, xs, ys, out, name=name,
                                     sigma=SIGMA)

    tc, first, g_turns = in_turns(run("tc", "gaussian"),
                                  run("pair_tile", "gaussian"), 10,
                                  device=True)
    lap, lap_first, l_turns = in_turns(run("tiled", "laplace"),
                                       run("pair_tile", "laplace"), 10,
                                       device=True)
    scale = -0.5 / SIGMA ** 2
    chain = time_ms(lambda: torch.exp(torch.cdist(xs, ys).square_()
                                      .mul_(scale)), 10)
    core_bound = bound_ms(*tile_cost(n, m, D))
    rec = kernel_record(
        "kernel_tile", "src/repro_torch/csrc/kernel_tile.cu",
        "src/repro/kernels/kernel_tile/kernel_tile.py:93",
        tune["b11_launches"], max(kres["kernel_tile"], tune["b11_err"]), tc,
        time_ms(lambda: pairwise_kernel_ref(xs, ys, sigma=SIGMA), 10),
        kernel_tile_tc_bound(n, m, D),
        unit=f"one launch: K ({n} x {m}, d {D}), gaussian",
        kernel="split TF32 (TMA loads and stores, wgmma, warp-specialised)",
        tc_launches=tune["b11_launches"],
        path="the autotune sweep's pairwise_kernel stage (phase 8e)",
        bound_f32_ms=core_bound[0],
        turns_ms={"tc": [g_turns[0], g_turns[3]],
                  "pair_tile": [g_turns[1], g_turns[2]]},
        cuda_core_ms=first, previous_ms=first,
        previous="pair_tile (kernel_tile_f32, the first design)",
        laplace={"tiled_ms": lap, "pair_tile_ms": lap_first,
                 "turns_ms": l_turns, "bound_ms": core_bound[0],
                 "bound_by": core_bound[1]},
        library_chain_ms=chain,
        library_chain="torch.cdist -> square -> scale -> exp")
    say(f"[9 timing] kernel_tile in turns (tc, pair_tile, pair_tile, tc), "
        f"device time, gaussian: "
        f"{', '.join(f'{t:.4f}' for t in g_turns)} ms; tc {tc:.4f} ms "
        f"against its bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
        f"the CUDA cores' {core_bound[0]:.4f} ms; the CUDA-core kernel, "
        f"the first design (pair_tile) {first:.4f} ms")
    say(f"[9 timing] kernel_tile laplace in turns (tiled, pair_tile, "
        f"pair_tile, tiled), device time: "
        f"{', '.join(f'{t:.4f}' for t in l_turns)} ms; "
        f"tiled {lap:.4f}, pair_tile {lap_first:.4f} ms (bound "
        f"{core_bound[0]:.4f} ms, {core_bound[1]})")
    return rec


def phase_solvers(fit, sw, dev) -> dict:
    """Phase 8b: every part of the exact-kernel solvers' phase."""
    t = time.perf_counter()
    kres = phase_solver_kernels(fit, dev)
    phase_bench_cg(dev)
    ex = phase_exact_krr(fit, dev)
    ex.update(x=fit["x"], xt=fit["xt"])
    slq = phase_slq(sw, dev)
    say(f"[8b solvers] phase done in {time.perf_counter() - t:.1f} s")
    return {"kres": kres, "exact": ex, "slq": slq}


# ---------------------------------------------------------------------------
# Phase 8c: the life of a model after its fit -- landmark policies, a rank
# budget, online updates
# ---------------------------------------------------------------------------

def policy_dist_cost(blocks, centers, metric="l2"):
    """policy_dist: blocks and centers read once, the distances written
    once; per pair the least work of the metric: 2d + 3 for "l2" (the norm
    identity, each point's squared norm once, as ``kernel_flops`` counts
    it, without the epilogue), 3d for "l1" (subtract, absolute, add)."""
    b, m, d = blocks.shape
    r = centers.shape[1]
    nbytes = blocks.element_size() * (b * m * d + b * r * d + b * m * r)
    pairs = b * m * r
    if metric == "l1":
        return nbytes, 3 * d * pairs
    return nbytes, pairs * (2 * d + 3) + 2 * d * b * (m + r)


def leaf_update_cost(lo, linv, b, c):
    """leaf_update: lo, Linv, B and C read once, both (n0 + k)^2 factors
    written once; B Linv^T and L21 Linv over the triangle (k n0^2 each),
    S (k^2 n0), the k x k factor and its inverse (k^3 / 3 each) and
    -X T (k^2 n0)."""
    p, n0, _ = lo.shape
    k = b.shape[1]
    ne = n0 + k
    nbytes = lo.element_size() * (2 * p * n0 * n0 + p * k * n0 + p * k * k
                                  + 2 * p * ne * ne)
    return nbytes, p * (2 * k * n0 * n0 + 2 * k * k * n0 + 2 * k ** 3 / 3)


@contextlib.contextmanager
def plain_policy_stage():
    """Route the landmark policies' ``policy_dist`` stage through its plain
    version on the card: the plain route of a comparison (a forced "torch"
    backend refuses CUDA tensors by design)."""
    from repro_torch.kernels.policy_stage.ref import policy_dist_ref
    from repro_torch.landmarks import policy

    stage = policy.stage_policy_dist
    policy.stage_policy_dist = lambda b, c, metric, config: policy_dist_ref(
        b.contiguous(), c.contiguous(), metric=metric)
    try:
        yield
    finally:
        policy.stage_policy_dist = stage


def check_policy_dist(blocks, centers, metric, rtol):
    """B12 against its plain version on the same inputs: max |d - d_plain|
    <= rtol * max d_plain (1e-5 in float32, 1e-12 in float64).  Both sum
    the features directly, in one order; the kernel fuses each
    multiply-add."""
    from repro_torch.kernels.policy_stage import ops
    from repro_torch.kernels.policy_stage.ref import policy_dist_ref

    got = ops.policy_dist(blocks, centers, metric=metric)
    want = policy_dist_ref(blocks, centers, metric=metric)
    if ops.route(blocks.dtype, blocks.shape[2]) == "tiled":
        # the register-tiled kernel sums as the pair_tile kernel does
        old = torch.empty_like(got)
        ops.launch_kernel("pair_tile", blocks, centers, old, metric=metric)
        sync()
        require(torch.equal(got, old), f"policy_dist[{metric}] "
                f"{tuple(blocks.shape)}: tiled and pair_tile kernels equal "
                "bit for bit")
    sync()
    rel = check_rel(f"policy_dist[{metric}] {tuple(blocks.shape)}", got, want,
                    rtol)
    return rel, float((got - want).abs().max())


def route_indices(pol, blocks, draws):
    """One level's landmark indices through B12 and through its plain
    version, from the same draws."""
    from repro_torch.landmarks.policy import select_indices

    idx_k = select_indices(pol, blocks, RANK, "l2", draws=draws)
    with plain_policy_stage():
        idx_p = select_indices(pol, blocks, RANK, "l2", draws=draws)
    return idx_k, idx_p


def landmark_rows_ok(f) -> bool:
    """Every node's landmarks are rows of its own block (distance 0 to one
    of them, summed directly, so exactly 0 for the same row) and no row
    twice (no zero distance between two landmarks)."""
    from repro_torch.kernels.build_stage.ref import direct_dist

    for lvl, lm in enumerate(f.landmarks):
        blocks = f.x_sorted.view(1 << lvl, f.n >> lvl, D)
        hit = direct_dist(blocks, lm, "l2").amin(dim=1)
        among = direct_dist(lm, lm, "l2")
        among.diagonal(dim1=1, dim2=2).fill_(float("inf"))
        if not (bool((hit == 0).all()) and bool((among > 0).all())):
            return False
    return True


def masks_ok(f, budget: int) -> bool:
    """Prefix masks, every rank in [8, RANK], their sum within budget."""
    ranks = torch.cat([mk.sum(dim=1) for mk in f.rank_mask])
    prefix = all(bool((mk[:, 1:] <= mk[:, :-1]).all()) for mk in f.rank_mask)
    return (prefix and int(ranks.min()) >= 8 and int(ranks.max()) <= RANK
            and int(ranks.sum()) <= budget)


def lifecycle_b12(fit, dev) -> dict:
    """Phase 8c (a): B12 against its plain version at covtype width (f32,
    "l2" at levels 0, 6 and 11 with the fit's landmarks as centers, "l1"
    at level 6, the leverage pilot's shapes) and at n = 4,096 in f64."""
    f = fit["model"].factors
    errs, rows = [], []
    mid = LEVELS // 2
    for lvl, metric in ((0, "l2"), (mid, "l2"), (LEVELS - 1, "l2"),
                        (mid, "l1")):
        blocks = f.x_sorted.view(1 << lvl, f.n >> lvl, D)
        rel, err = check_policy_dist(blocks, f.landmarks[lvl], metric, 1e-5)
        errs.append(err)
        rows.append(f"level {lvl} {metric} {tuple(blocks.shape)} rel "
                    f"{rel:.3e}")
    pilot = f.x_sorted.view(1, f.n, D)[:, :2 * RANK].contiguous()
    rel_p, _ = check_policy_dist(f.x_sorted.view(1, f.n, D), pilot, "l2",
                                 1e-5)
    rows.append(f"leverage pilot (1, {f.n}, {D}) x {2 * RANK} rel "
                f"{rel_p:.3e}")
    x64 = make_data(EXACT_N, 8, dev, torch.Generator(device=dev).manual_seed(
        SEED + 2), dtype=torch.float64)[0]
    rel64, _ = check_policy_dist(x64.view(1, EXACT_N, D),
                                 x64[:RANK].view(1, RANK, D).contiguous(),
                                 "l2", 1e-12)
    rel64_1, _ = check_policy_dist(x64.view(8, EXACT_N // 8, D),
                                   x64.view(8, EXACT_N // 8, D)[:, :RANK]
                                   .contiguous(), "l1", 1e-12)
    say("[8c lifecycle] policy_dist vs plain, f32 at covtype width: "
        + "; ".join(rows) + " (tolerance 1e-5 of the largest distance; the "
        "register-tiled kernel equal to the pair_tile kernel bit for bit) ok; "
        "f64 at "
        f"n={EXACT_N}: l2 rel {rel64:.3e}, l1 rel {rel64_1:.3e} (tolerance "
        f"1e-12) ok")
    policy_indices_f32(f, dev)
    return {"err": max(errs)}


def policy_indices_f32(f, dev) -> None:
    """Phase 8c (a): at covtype width in f32, levels 0, 6 and 11 of the
    fit's tree, the k-means and leverage indices through B12 (its
    register-tiled kernel, counted) equal the plain route's, from the same
    draws."""
    from repro_torch.kernels.policy_stage.ops import policy_dist
    from repro_torch.landmarks.policy import get_policy

    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    rows = []
    for name in ("kmeans", "leverage"):
        pol = get_policy(name)
        for lvl in (0, LEVELS // 2, LEVELS - 1):
            blocks = f.x_sorted.view(1 << lvl, f.n >> lvl, D)
            draws = pol.draws(1 << lvl, f.n >> lvl, RANK, dtype=torch.float32,
                              device=dev, generator=gen)
            before = policy_dist.tiled_launches
            idx_k, idx_p = route_indices(pol, blocks, draws)
            tiled = policy_dist.tiled_launches - before
            require(tiled > 0, f"{name} level {lvl}: the kernel route ran "
                    "the register-tiled kernel")
            require(torch.equal(idx_k, idx_p), f"f32 {name} level {lvl}: "
                    "kernel and plain routes' indices equal")
            rows.append(f"{name} level {lvl} ({tiled} tiled launches)")
    say("[8c lifecycle] f32 at covtype width, the policies' indices through "
        "the register-tiled kernel equal the plain route's: "
        + ", ".join(rows) + " ok")


def policy_fit(fit, dev, name):
    """The full-width fit of phase 3 (its padding, tree and start draws)
    under landmark policy ``name`` with the rank budget, counted."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel

    ker = BaseKernel("gaussian", SIGMA, JITTER)
    t = time.perf_counter()
    model, launches, plain_calls = counted(lambda: krr.fit(
        fit["x"], fit["labels"], kernel=ker, lam=LAM, rank=RANK,
        leaf_size=LEAF, classification=True, landmarks=name,
        rank_budget=LIFE_BUDGET,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1)))
    t_fit = time.perf_counter() - t
    per_level = 9 if name == "kmeans" else 2
    require_launches(f"krr.fit(landmarks={name!r}, rank_budget)", launches,
                     plain_calls, {"gram_chol": 1, "gram_chol_levels": 1,
                                   "cross_solve_levels": 1, "leaf_factor": 1,
                                   "leaf_solve": 3, "leaf_matvec": 3,
                                   "hck_leaf_project": 1,
                                   "policy_dist": per_level * LEVELS})
    return model, launches, t_fit


def fit_residual(model, fit, dev) -> tuple[float, float]:
    """(f32 residual ||(K + lam I) alpha - y|| / ||y|| through the port's
    matvec, the f32 floor eps32 ||K 1|| / ||1||) of a full-width fit."""
    from repro_torch.core.partition import pad_points

    _, yp, _ = pad_points(fit["x"], fit["labels"], LEAF, LEVELS,
                          generator=torch.Generator(device=dev)
                          .manual_seed(SEED + 1))
    r = fit_floor(model, one_vs_all(yp, torch.float32))
    return r["res"], r["floor"]


def policy_parity_f64(dev) -> dict:
    """Phase 8c (b): at n = 4,096 in f64, per policy, the kernel route's
    indices equal the plain route's level by level, and the budgeted
    build through the kernels equals the plain build on the CPU on those
    landmarks (masks exactly, factors within 1e-10)."""
    from repro_torch.core.hck import build_hck
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.core.partition import build_partition
    from repro_torch.landmarks.policy import get_policy

    x64 = make_data(EXACT_N, 8, dev, torch.Generator(device=dev).manual_seed(
        SEED + 2), dtype=torch.float64)[0]
    dirs = [torch.eye(D, dtype=torch.float64, device=dev)[
        (lvl + torch.arange(1 << lvl)) % D] for lvl in range(EXACT_LEVELS)]
    budget = ((1 << EXACT_LEVELS) - 1) * RANK // 2
    ker = BaseKernel("gaussian", SIGMA, JITTER)
    x_sorted, _ = build_partition(x64, EXACT_LEVELS, directions=dirs)
    out = {}
    for name in ("kmeans", "leverage"):
        pol = get_policy(name)
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        draws = [pol.draws(1 << lvl, EXACT_N >> lvl, RANK,
                           dtype=torch.float64, device=dev, generator=gen)
                 for lvl in range(EXACT_LEVELS)]
        fk, launches, plain_calls = counted(lambda: build_hck(
            x64, levels=EXACT_LEVELS, rank=RANK, kernel=ker, policy=name,
            rank_budget=budget, directions=dirs, policy_draws=draws))
        require_launches(f"n={EXACT_N} f64 build_hck(policy={name!r})",
                         launches, plain_calls, {
                             "gram_chol": 1, "gram_chol_levels": 1,
                             "cross_solve_levels": 1,
                             "policy_dist": (9 if name == "kmeans" else 2)
                             * EXACT_LEVELS, "policy_dist_tiled": 0})
        plain_idx = []
        for lvl in range(EXACT_LEVELS):
            blocks = x_sorted.view(1 << lvl, EXACT_N >> lvl, D)
            idx_k, idx_p = route_indices(pol, blocks, draws[lvl])
            require(torch.equal(idx_k, idx_p), f"n={EXACT_N} f64 {name} "
                    f"level {lvl}: kernel and plain routes' indices equal")
            plain_idx.append(idx_p.cpu())
        fp = build_hck(x64.cpu(), levels=EXACT_LEVELS, rank=RANK, kernel=ker,
                       rank_budget=budget, directions=[v.cpu() for v in dirs],
                       landmark_index=plain_idx)
        require(all(torch.equal(a.cpu(), b) for a, b in zip(fk.rank_mask,
                                                          fp.rank_mask)),
                f"n={EXACT_N} f64 {name}: masks equal")
        fp = to_device(fp, dev)
        gaps = factors_gap(fk, fp)
        gaps["matvec"] = matvec_gap(fk, fp, gen)
        for k, v in gaps.items():
            require(v <= 1e-10, f"n={EXACT_N} f64 {name} kernel vs plain "
                    f"route {k} {v:.3e} <= 1e-10")
        out[name] = (gaps, fk.ranks)
    say(f"[8c lifecycle] n={EXACT_N} f64, budget {budget}: kernel route vs "
        "plain route (the policies' indices through the plain policy_dist "
        "on the card, the build on the CPU): indices equal at every level, "
        "masks equal, " + "; ".join(
            f"{name} " + ", ".join(f"{k} {v:.3e}" for k, v in g.items())
            + f", ranks {tuple(r)}" for name, (g, r) in out.items())
        + " (each <= 1e-10) ok")
    return out


def to_device(f, dev):
    """Factors ``f`` moved to ``dev``."""
    from repro_torch.core.hck import HCKFactors
    from repro_torch.core.partition import PartitionTree

    mv = lambda t: t.to(dev)
    tr = f.tree
    return HCKFactors(
        mv(f.x_sorted), PartitionTree(mv(tr.perm), tuple(map(mv, tr.directions)),
                                      tuple(map(mv, tr.thresholds))),
        tuple(map(mv, f.landmarks)), tuple(map(mv, f.sigma)),
        tuple(map(mv, f.sigma_cho)), tuple(map(mv, f.w)), mv(f.u),
        mv(f.adiag), None if f.rank_mask is None
        else tuple(map(mv, f.rank_mask)))


def lifecycle_fits(fit, dev) -> dict:
    """Phase 8c (b): the full-width k-means and leverage fits with the rank
    budget, their gates, and the f64 parity of the two routes."""
    from repro_torch.landmarks.policy import get_policy

    xt, yt = fit["xt"], fit["yt"]
    res = {}
    for name in ("kmeans", "leverage"):
        model, launches, t_fit = policy_fit(fit, dev, name)
        f = model.factors
        require(landmark_rows_ok(f), f"{name}: every node's landmarks are "
                "distinct rows of its own block")
        require(masks_ok(f, LIFE_BUDGET), f"{name}: prefix masks, ranks in "
                f"[8, {RANK}], sum <= {LIFE_BUDGET}: {tuple(f.ranks)}")
        rres, floor = fit_residual(model, fit, dev)
        require(rres <= floor, f"{name} fit f32 residual {rres:.3e} <= floor "
                f"{floor:.3e}")
        acc = float((model.predict_class(xt) == yt).double().mean())
        acc0 = float((fit["model"].predict_class(xt) == yt).double().mean())
        # the routes at full width: fresh draws per level, through B12 and
        # through its plain version; f32 argmins may differ, so the share
        # of nodes whose landmark sets agree is printed, not gated
        pol = get_policy(name)
        gen = torch.Generator(device=dev).manual_seed(SEED + 12)
        same = nodes = 0
        for lvl in range(LEVELS):
            blocks = f.x_sorted.view(1 << lvl, f.n >> lvl, D)
            draws = pol.draws(1 << lvl, f.n >> lvl, RANK, dtype=f.x_sorted.dtype,
                              device=dev, generator=gen)
            idx_k, idx_p = route_indices(pol, blocks, draws)
            same += int((idx_k.sort(dim=1).values
                         == idx_p.sort(dim=1).values).all(dim=1).sum())
            nodes += 1 << lvl
        say(f"[8c lifecycle] krr.fit(landmarks={name!r}, rank_budget="
            f"{LIFE_BUDGET}) at covtype width: {t_fit:.3f} s (first call); "
            f"ranks (min, max, sum) {tuple(f.ranks)} of {RANK} x "
            f"{nodes} slots; landmarks distinct rows of their blocks, prefix "
            f"masks ok; f32 residual {rres:.3e} <= floor {floor:.3e} ok; "
            f"launches { {k: v for k, v in launches.items() if v} }; test "
            f"accuracy {acc:.4f} (the uniform model of phase 3: "
            f"{acc0:.4f}); kernel vs plain route, landmark sets equal "
            f"in {same} of {nodes} nodes (f32, not gated)")
        res[name] = {"model": model, "launches": launches, "t_fit": t_fit,
                     "acc": acc, "resid": rres, "floor": floor,
                     "same_nodes": (same, nodes), "ranks": tuple(f.ranks)}
        if name != "kmeans":
            del model, res[name]["model"]
    res["f64"] = policy_parity_f64(dev)
    return res


def lifecycle_sweep(fit, sw, km, dev) -> dict:
    """Phase 8c (c): the sweep's policy axis.  ``replan_policy`` of phase
    7's plan equals a k-means plan drawn afresh, and its budgeted
    ``sweep_factors`` at sigma 1 equal the k-means fit's factors."""
    from repro_torch.core.hck import (build_sweep_plan, replan_policy,
                                      sweep_factors)
    from repro_torch.core.kernels_fn import BaseKernel

    t = time.perf_counter()
    kplan = replan_policy(sw["plan"], rank=RANK, policy="kmeans",
                          generator=after_padding(fit, dev))
    sync()
    t_replan = time.perf_counter() - t
    fresh = build_sweep_plan(sw["xp"], levels=LEVELS, rank=RANK,
                             policy="kmeans",
                             generator=after_padding(fit, dev))
    same = (all(torch.equal(a, b) for field in ("landmarks", "lm_self",
                                                "lm_cross")
                for a, b in zip(getattr(kplan, field), getattr(fresh, field)))
            and torch.equal(kplan.leaf_cross, fresh.leaf_cross))
    require(same, "replan_policy(plan, kmeans) == build_sweep_plan(kmeans)")
    del fresh
    fs = sweep_factors(kplan, BaseKernel("gaussian", SIGMA, JITTER),
                       rank_budget=LIFE_BUDGET)
    fb = km.factors
    require(all(torch.equal(a, b) for a, b in zip(fs.landmarks,
                                                  fb.landmarks)),
            "the k-means plan draws the k-means fit's landmarks")
    require(all(torch.equal(a, b) for a, b in zip(fs.rank_mask, fb.rank_mask)),
            "budgeted sweep_factors masks == the k-means fit's")
    gaps = factors_gap(fs, fb)
    gaps["matvec"] = matvec_gap(fs, fb, torch.Generator(device=dev)
                                .manual_seed(SEED + 13))
    for k, v in gaps.items():
        require(v <= 1e-4, f"budgeted sweep vs build_hck {k} {v:.3e}")
    say(f"[8c lifecycle] replan_policy(phase 7's plan, kmeans) in "
        f"{t_replan:.3f} s == build_sweep_plan(kmeans) (landmarks and tiles "
        f"bit for bit) ok; sweep_factors(rank_budget={LIFE_BUDGET}) at sigma "
        f"{SIGMA} vs the k-means fit's build_hck: masks equal, " + ", ".join(
            f"{k} {v:.3e}" for k, v in gaps.items()) + " (each <= 1e-4) ok")
    return {"gaps": gaps, "t_replan": t_replan}


def replay_insert(model, x_new, y_new):
    """``update.insert`` exactly as ``fit_incremental`` calls it (the same
    padding draws: a generator seeded with n on the model's device)."""
    from repro_torch.core import hmatrix, krr, update

    f = model.factors
    ys = hmatrix.matvec(f, model.alpha, model.solve_config) \
        + model.lam * model.alpha
    targets = krr._encode_arrivals(model, y_new, f.x_sorted.dtype)
    return update.insert(
        f, x_new, model.kernel, config=model.solve_config, y_new=targets,
        y_sorted=ys, jitter_rows=model.base_leaf_size,
        linv_leaf=model.leaf_linv, generator=torch.Generator(
            device=f.x_sorted.device).manual_seed(f.n))


def check_update_kernel(lo, linv, b, c, rtol):
    """B13 against its plain version: the old quadrants of both are the
    inputs bit for bit and the upper-right blocks zero; the new rows of L
    and of L^-1 within rtol relative (1e-4 in float32, 1e-10 in
    float64)."""
    from repro_torch.kernels.update_stage.ops import leaf_update
    from repro_torch.kernels.update_stage.ref import leaf_update_ref

    n0 = lo.shape[1]
    got = leaf_update(lo, linv, b, c)
    want = leaf_update_ref(lo, linv, b, c)
    sync()
    for tag, g, w, old in (("L", got[0], want[0], lo),
                           ("L^-1", got[1], want[1], linv)):
        require(torch.equal(g[:, :n0, :n0], old)
                and torch.equal(w[:, :n0, :n0], old)
                and not bool(g[:, :n0, n0:].any())
                and not bool(torch.triu(g, 1).any()),
                f"leaf_update {tag}: old quadrant bit for bit, exact zeros "
                "above the diagonal (B4 skips that triangle)")
    rel_l = check_rel("leaf_update L new rows", got[0][:, n0:], want[0][:, n0:],
                      rtol)
    rel_i = check_rel("leaf_update L^-1 new rows", got[1][:, n0:],
                      want[1][:, n0:], rtol)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return rel_l, rel_i, err


def update_round(model, x_new, y_new, expected, what, **kw):
    """One counted ``model.update``: (new model, info, launches, wall s).
    ``expected`` (a dict, or a function of the new model and its info
    giving one) is required of the launches."""
    t = time.perf_counter()
    (m2, info), launches, plain_calls = counted(
        lambda: model.update(x_new, y_new, **kw))
    wall = time.perf_counter() - t
    if expected is not None:
        want = expected(m2, info) if callable(expected) else expected
        require_launches(what, launches, plain_calls, want)
    return m2, info, launches, wall


def grown_kernel_checks(f1, m1, ys1, xt) -> dict:
    """B1-B7 against their plain versions at the grown leaf size (n0 = 128 +
    k after one round: no longer a multiple of 8, 16 or 32)."""
    from repro_torch.core import hmatrix

    p, n0g = f1.num_leaves, f1.leaf_size
    k = n0g - LEAF
    leaves = f1.x_sorted.view(p, n0g, D)
    res = {"n0": n0g}
    res["gram_chol"] = check_build(leaves, False, 1e-4)[1]
    x_app = leaves[:, LEAF:].contiguous()
    lm_rep = torch.repeat_interleave(f1.landmarks[-1], 2, dim=0).contiguous()
    rel2, res["cross_solve"] = check_cross((x_app, lm_rep, m1.leaf_linv
                                            .contiguous()), None)
    eye = torch.eye(n0g, device=f1.adiag.device)
    dleaf = (hmatrix._leaf_schur(f1) + LAM * eye).contiguous()
    rel3, _, res["leaf_factor"], _, _ = check_factor(dleaf, 1e-4)
    b = ys1.view(p, n0g, -1).contiguous()
    inv = m1.inverse
    rel4, res["leaf_solve"] = check_leaf("solve", tuple(
        t.contiguous() for t in (inv.linv, inv.u, inv.sigma[-1], b)), 1e-4)
    rel5, res["leaf_matvec"] = check_leaf("matvec", (f1.adiag, f1.u, b), 1e-4)
    res["hck_leaf_project"] = check_project(f1.u, m1.plan.w_leaf)
    local, walk, pair = bucket_inputs(m1.factors, m1.plan, xt[:4096])
    for stage, a, both in (("oos_local", local, False),
                           ("oos_walk", walk, False),
                           ("oos_local_walk", pair, True)):
        res[stage] = check_contract(a, name="gaussian", rtol=1e-4,
                                    pair=both)[0]
    say(f"[8c lifecycle] kernels at the grown leaf size n0={n0g} (128 + "
        f"{k}): gram_chol Adiag, cross_solve on the appended {k}-row slabs "
        f"(rel {rel2:.3e}, componentwise bound), leaf_factor (L rel "
        f"{rel3:.3e}), leaf_solve (rel {rel4:.3e}), leaf_matvec (rel "
        f"{rel5:.3e}), leaf_project, oos_contract local, walk and both in "
        f"one launch against "
        f"their plain versions, each within its phase-4 tolerance ok")
    return res


def lifecycle_update(fit, km, dev) -> dict:
    """Phase 8c (d): two rounds of ``model.update`` on the budgeted k-means
    model (refresh="inverse"), gated against ``refit_frozen`` + a fresh
    inverse, solve and plan; B13 and the grown-size kernels against their
    plain versions; the downdate round trip; then one "stale" and one
    "exact" round."""
    from repro_torch.core import hmatrix, krr, oos, update

    xt = fit["xt"]
    res = {}
    x1, y1 = fresh_points(UPDATE_Q, SEED + 20, dev)
    x2, y2 = fresh_points(UPDATE_Q, SEED + 21, dev)
    x3, y3 = fresh_points(UPDATE_Q, SEED + 22, dev)
    inverse_round = {"cross_solve": 1, "leaf_update": 1, "leaf_solve": 3,
                     "leaf_matvec": 5, "hck_leaf_project": 1}
    # ---- the update path: counts set to 0 just before each round, read
    # just after ----
    m1, info1, l1, t1 = update_round(km, x1, y1, inverse_round,
                                     "update round 1 (inverse)")
    m2, info2, l2, t2 = update_round(m1, x2, y2, inverse_round,
                                     "update round 2 (inverse)")
    # ----------------------------------------------------------------------
    for tag, info in (("1", info1), ("2", info2)):
        require(info.converged and bool(torch.isfinite(
            torch.tensor(info.residual))), f"round {tag} solved: {info}")
    # the same inserts replayed: the grown factors bit for bit, and back
    f1, ys1, rec1 = replay_insert(km, x1, y1)
    require(torch.equal(f1.u, m1.factors.u)
            and torch.equal(f1.adiag, m1.factors.adiag),
            "round 1 replayed: the same grown factors")
    back = update.downdate(f1, rec1.k)
    base = km.factors
    require(all(torch.equal(getattr(back, fld), getattr(base, fld))
                for fld in ("x_sorted", "u", "adiag"))
            and torch.equal(back.tree.perm, base.tree.perm),
            "downdate(insert(f), k) == f field by field")
    # B13 at round 1's launch
    bb, cc = hmatrix.extension_blocks(f1, n0_base=LEAF, ridge=LAM)
    b13_args = tuple(t.contiguous() for t in (km.leaf_lo, km.inverse.linv,
                                              bb, cc))
    rel_l, rel_i, res["leaf_update_err"] = check_update_kernel(*b13_args,
                                                               1e-4)
    res["b13_args"] = b13_args
    res["grown"] = grown_kernel_checks(f1, m1, ys1, xt)
    del f1, ys1, back, bb, cc
    # the oracle of round 2: its insert replayed on m1, the leaf stages
    # rebuilt from scratch, a fresh inverse, solve and plan
    f2, ys2, _ = replay_insert(m1, x2, y2)
    require(torch.equal(f2.u, m2.factors.u), "round 2 replayed")
    # B13 at round 2's launch (the grown leaves of round 1 bordered again)
    bb, cc = hmatrix.extension_blocks(f2, n0_base=m1.factors.leaf_size,
                                      ridge=LAM)
    res["b13_args2"] = tuple(t.contiguous() for t in (
        m1.leaf_lo, m1.inverse.linv, bb, cc))
    rel_l2, rel_i2, res["leaf_update_err2"] = check_update_kernel(
        *res["b13_args2"], 1e-4)
    del bb, cc
    f_ref = update.refit_frozen(f2, km.kernel, jitter_rows=LEAF)
    inv_ref, _ = hmatrix.invert_with_leaf(f_ref, LAM)
    alpha_ref = hmatrix.solve_with_inverse(f_ref, inv_ref, ys2, ridge=LAM)
    oracle = krr.HCKRegressor(km.kernel, f_ref, oos.prepare(f_ref, alpha_ref),
                              alpha_ref, km.classes, lam=LAM)
    t = time.perf_counter()
    pred, ls, ps = counted(lambda: m2.predict(xt))
    t_serve = time.perf_counter() - t
    require(ls["oos_contract"] == ls["oos_contract_pair"] == -(-N_TEST // 4096)
            and not any(ps.values()), "the updated model served through "
            f"oos_contract, one launch a bucket: {ls}, {ps}")
    want = oracle.predict(xt)
    gap = rel_max(pred, want)
    floor = res_floor(km, dev)
    require(pred.shape == (N_TEST, N_CLASSES) and bool(
        torch.isfinite(pred).all()), "updated model's predictions")
    require(gap <= floor, f"updated model vs refit_frozen oracle predictions "
            f"rel {gap:.3e} <= f32 floor {floor:.3e}")
    acc2 = float((m2.predict_class(xt) == fit["yt"]).double().mean())
    del f2, ys2, f_ref, inv_ref, alpha_ref, oracle, want
    # B6 at each grown leaf size (round 1's n0 in grown_kernel_checks)
    b6_grown = {m2.factors.leaf_size: check_project(m2.factors.u,
                                                    m2.plan.w_leaf)}
    # f64 at n = 4,096: B13 against its plain version
    res["b13_f64"] = b13_f64(dev)
    # one stale round and one exact round, each from m2
    m3s, info3s, l3s, t3s = update_round(m2, x3, y3, None, "stale",
                                         refresh="stale", tol=STALE_TOL,
                                         maxiter=STALE_MAXITER)
    require(l3s["leaf_update"] == 0 and l3s["leaf_factor"] == 0
            and l3s["cross_solve"] == 1 and l3s["gram_chol"] == 0
            and l3s["policy_dist"] == 0 and l3s["hck_leaf_project"] == 1,
            f"stale round launches: {l3s}")
    require(info3s.converged and info3s.residual <= STALE_TOL,
            f"stale round converged to {STALE_TOL}: {info3s}")
    del m3s
    m3e, info3e, l3e, t3e = update_round(
        m2, x3, y3, {"cross_solve": 1, "leaf_factor": 1, "leaf_solve": 3,
                     "leaf_matvec": 5, "hck_leaf_project": 1},
        "exact round", refresh="exact")
    require(info3e.converged, f"exact round: {info3e}")
    n0_3 = m3e.factors.leaf_size
    b6_grown[n0_3] = check_project(m3e.factors.u, m3e.plan.w_leaf)
    del m3e
    nz = lambda d: {k: v for k, v in d.items() if v}
    say(f"[8c lifecycle] model.update x2 (refresh='inverse', {UPDATE_Q} "
        f"arrivals each) on the budgeted k-means model: leaves 128 -> "
        f"{m1.factors.leaf_size} -> {m2.factors.leaf_size} (k {info1.record.k}"
        f", {info2.record.k}); wall {t1:.3f} s, {t2:.3f} s (first and second "
        f"call); residuals {info1.residual:.3e}, {info2.residual:.3e}; "
        f"launches {nz(l1)}, {nz(l2)}; no plain version")
    say(f"[8c lifecycle] downdate(insert(f)) == f bit for bit ok; "
        f"leaf_update at round 1 {tuple(b13_args[0].shape)} + k "
        f"{b13_args[2].shape[1]}: old quadrants bit for bit, new rows rel "
        f"L {rel_l:.3e}, L^-1 {rel_i:.3e}; at round 2 "
        f"{tuple(res['b13_args2'][0].shape)} + k "
        f"{res['b13_args2'][2].shape[1]}: rel L {rel_l2:.3e}, L^-1 "
        f"{rel_i2:.3e} (tolerance 1e-4); f64 n={EXACT_N}: {res['b13_f64']}")
    say(f"[8c lifecycle] round 2 vs refit_frozen + invert_with_leaf + solve "
        f"+ prepare, all {N_TEST} test queries: rel {gap:.3e} <= f32 floor "
        f"{floor:.3e} ok; serving the updated model {t_serve:.3f} s "
        f"({N_TEST / t_serve:.0f} queries/s), launches {nz(ls)}; test "
        f"accuracy {acc2:.4f}; needs_rebuild {info2.needs_rebuild}")
    say(f"[8c lifecycle] refresh='stale' round from round 2: "
        f"{info3s.iterations} PCG iterations, residual {info3s.residual:.3e} "
        f"<= tol {STALE_TOL}, {t3s:.3f} s, launches {nz(l3s)}; "
        f"refresh='exact' round: leaf_factor at n0={n0_3}, residual "
        f"{info3e.residual:.3e}, {t3e:.3f} s, launches {nz(l3e)} ok")
    say(f"[8c lifecycle] leaf_project at the grown leaf sizes of round 2 and "
        f"the exact round against its plain version, within "
        f"2*n0*eps*|U|^T|b|: max|dc| "
        f"{', '.join(f'{e:.3e} (n0={n})' for n, e in b6_grown.items())} ok")
    res.update(launches=[l1, l2], walls=[t1, t2], gap=gap, floor=floor,
               stale=(info3s.iterations, info3s.residual, t3s),
               exact=(info3e.residual, t3e), t_serve=t_serve, acc=acc2,
               k=(info1.record.k, info2.record.k))
    return res


def res_floor(model, dev) -> float:
    """The f32 floor eps32 ||K 1|| / ||1|| of a full-width model."""
    from repro_torch.core import hmatrix

    f = model.factors
    ones = torch.ones((f.n, 1), device=dev)
    return torch.finfo(torch.float32).eps * float(
        torch.linalg.vector_norm(hmatrix.matvec(f, ones)) / math.sqrt(f.n))


def b13_f64(dev) -> str:
    """B13 against its plain version in f64 at n = 4,096: a fitted f64
    model takes 512 arrivals (its insert replayed)."""
    from repro_torch.core import hmatrix, krr
    from repro_torch.core.kernels_fn import BaseKernel

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    x64, labels, _, _ = make_data(EXACT_N, 8, dev, gen, dtype=torch.float64)
    m64 = krr.fit(x64, labels, kernel=BaseKernel("gaussian", SIGMA, JITTER),
                  lam=LAM, rank=RANK, leaf_size=LEAF, classification=True,
                  generator=torch.Generator(device=dev).manual_seed(SEED + 14))
    xq, yq = fresh_points(512, SEED + 23, dev)
    f1, _, rec = replay_insert(m64, xq.double(), yq)
    bb, cc = hmatrix.extension_blocks(f1, n0_base=LEAF, ridge=LAM)
    rel_l, rel_i, _ = check_update_kernel(
        *(t.contiguous() for t in (m64.leaf_lo, m64.inverse.linv, bb, cc)),
        1e-10)
    return (f"k {rec.k}, new rows rel L {rel_l:.3e}, L^-1 {rel_i:.3e} "
            f"(tolerance 1e-10) ok")


def lifecycle_timing(fit, km, up, b12) -> list[dict]:
    """Phase 9, lifecycle: B12 at the k-means fit's twelve launch shapes
    (one Lloyd round) and the leverage pilot's, its register-tiled kernel
    against the pair_tile kernel in turns, B13 at both update rounds'
    launches (update_timing), beside their bounds, plain and library
    times."""
    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    f = km["model"].factors
    rows = []
    for lvl in range(LEVELS):
        blocks = f.x_sorted.view(1 << lvl, f.n >> lvl, D)
        rows.append(dist_timing(blocks, f.landmarks[lvl], "l2", reps=5))
    round_ = {k: sum(r[k] for r in rows) for k in rows[0]
              if k not in ("turns_ms", "bound_by")}
    whole = f.x_sorted.view(1, f.n, D)
    pilot = whole[:, :2 * RANK].contiguous()
    mid = LEVELS // 2
    blocks_m, lm_m = f.x_sorted.view(1 << mid, f.n >> mid, D), f.landmarks[mid]
    parts = {f"level{lvl}": rows[lvl] for lvl in (0, mid, LEVELS - 1)}
    parts["leverage_pilot_level0"] = dist_timing(whole, pilot, "l2", reps=5)
    parts[f"l1_level{mid}"] = dist_timing(blocks_m, lm_m, "l1", reps=5)
    fit_launches = km["launches"]["policy_dist"] + km["lev_launches"]
    rec12 = kernel_record(
        "policy_dist", src + "policy_dist.cu",
        tpu + "policy_stage/policy_stage.py:48", fit_launches, b12["err"],
        round_["ms"], round_["plain_ms"], (round_["bound_ms"], "bytes"),
        library=round_["library_ms"],
        unit=f"one k-means assignment round: {LEVELS} launches, one per "
             f"level (B x m = {f.n} rows, r = {RANK}, d = {D}, f32)",
        library_call="torch.cdist(p=2) ** 2 (p=1 for l1)",
        previous_ms=round_["previous_ms"],
        direct_sum_floor_ms=round_["direct_sum_floor_ms"],
        launches_kmeans_fit=km["launches"]["policy_dist"],
        launches_leverage_fit=km["lev_launches"], **parts)
    require(all(r["bound_by"] == "bytes" for r in rows),
            "policy_dist's bound is its bytes at every level")
    rounds = [update_timing(args) for args in (up["b13_args"],
                                               up["b13_args2"])]
    lo, _, b, _ = up["b13_args"]
    r1 = rounds[0]
    rec13 = kernel_record(
        "leaf_update", src + "leaf_update.cu",
        tpu + "update_stage/update_stage.py:62", sum(
            ln["leaf_update"] for ln in up["launches"]),
        max(up["leaf_update_err"], up["leaf_update_err2"]), r1["ms"],
        r1["plain_ms"], (r1["bound_ms"], r1["bound_by"]),
        unit=f"one launch: P={lo.shape[0]}, n0={lo.shape[1]}, "
             f"k={b.shape[1]}, f32 (update round 1; device time)",
        library_chain_ms=r1["chain_ms"],
        library_chain="torch.bmm + torch.linalg.cholesky + solve_triangular "
                      "+ torch.bmm (the border only, no copy of the old "
                      "quadrants)",
        round1=r1, round2=rounds[1])
    for rec in (rec12, rec13):
        extra = ""
        if "library_chain_ms" in rec:
            extra = (f", chain {rec['library_chain']} "
                     f"{rec['library_chain_ms']:.4f} ms")
        if "previous_ms" in rec:
            extra += f", previous design {rec['previous_ms']:.4f} ms"
        if "direct_sum_floor_ms" in rec:
            extra += (f", direct-sum issue floor "
                      f"{rec['direct_sum_floor_ms']:.4f} ms")
        say(f"[9 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']} ms{extra}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), launches {rec['launches']}")
    for key in ("round1", "round2"):
        p = rec13[key]
        say(f"[9 timing]   leaf_update {key} ({p['shape']}): kernel "
            f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, "
            f"chain {p['chain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
            f"({p['bound_by']})")
    for key in parts:
        p = rec12[key]
        say(f"[9 timing]   policy_dist {key}: kernel {p['ms']:.4f} ms, "
            f"previous design {p['previous_ms']:.4f} ms (in turns: "
            f"{p['turns_ms']}), plain {p['plain_ms']:.4f} ms, library "
            f"{p['library_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms, "
            f"direct-sum issue floor {p['direct_sum_floor_ms']:.4f} ms")
    return [rec12, rec13]


def update_timing(args) -> dict:
    """B13 at one launch's shape: the kernel (device time), the plain
    version, the chain of library calls for the border alone, the bound
    (bytes).  The design it replaced was timed in turns with it before it
    was removed (PERF.md section 6)."""
    from repro_torch.kernels.update_stage.ops import leaf_update
    from repro_torch.kernels.update_stage.ref import leaf_update_ref

    lo, linv, b, c = args
    p, n0, _ = lo.shape
    k = b.shape[1]
    eye = torch.eye(k, device=b.device)

    def chain():
        l21 = torch.bmm(b, linv.mT)
        l22 = torch.linalg.cholesky(c - torch.bmm(l21, l21.mT))
        x = torch.linalg.solve_triangular(l22, eye.expand_as(l22),
                                          upper=False)
        return l22, torch.bmm(x, torch.bmm(l21, linv))

    bound = bound_ms(*leaf_update_cost(*args))
    return {"shape": f"P {p}, n0 {n0}, k {k}",
            "ms": device_ms(lambda: leaf_update(*args), 10),
            "plain_ms": time_ms(lambda: leaf_update_ref(*args), 5),
            "chain_ms": time_ms(chain, 5), "bound_ms": bound[0],
            "bound_by": bound[1]}


def dist_timing(blocks, centers, metric, reps) -> dict:
    """B12 at one launch's shape: its register-tiled kernel (the path) and
    the pair_tile kernel it replaced in turns (tiled, pair_tile, pair_tile,
    tiled), the plain version, one torch.cdist call, the bound (bytes),
    and the direct sum's issue floor: an FSUB and an FFMA (or FADD) per
    feature and pair at 132 SMs x 128 lanes x 1.98 GHz."""
    from repro_torch.kernels.policy_stage import ops
    from repro_torch.kernels.policy_stage.ref import policy_dist_ref

    b, m, d = blocks.shape
    r = centers.shape[1]
    out = torch.empty((b, m, r), dtype=blocks.dtype, device=blocks.device)
    turns = [time_ms(lambda k=k: ops.launch_kernel(k, blocks, centers, out,
                                                   metric=metric), reps)
             for k in ("tiled", "pair_tile", "pair_tile", "tiled")]
    library = ((lambda: torch.cdist(blocks, centers, p=1)) if metric == "l1"
               else (lambda: torch.cdist(blocks, centers) ** 2))
    bound = bound_ms(*policy_dist_cost(blocks, centers, metric))
    return {"ms": (turns[0] + turns[3]) / 2,
            "previous_ms": (turns[1] + turns[2]) / 2,
            "turns_ms": {"tiled": [turns[0], turns[3]],
                         "pair_tile": [turns[1], turns[2]]},
            "plain_ms": time_ms(lambda: policy_dist_ref(
                blocks, centers, metric=metric), 2, warmup=1),
            "library_ms": time_ms(library, 3),
            "bound_ms": bound[0], "bound_by": bound[1],
            "direct_sum_floor_ms": direct_sum_floor_ms(b * m * r, d)}


def phase_lifecycle(fit, sw, dev) -> dict:
    """Phase 8c: every part of the lifecycle phase."""
    t = time.perf_counter()
    b12 = lifecycle_b12(fit, dev)
    fits = lifecycle_fits(fit, dev)
    km = fits["kmeans"]
    km["lev_launches"] = fits["leverage"]["launches"]["policy_dist"]
    sweep = lifecycle_sweep(fit, sw, km["model"], dev)
    up = lifecycle_update(fit, km["model"], dev)
    say(f"[8c lifecycle] phase done in {time.perf_counter() - t:.1f} s")
    return {"b12": b12, "fits": fits, "km": km, "sweep": sweep, "update": up}


# ---------------------------------------------------------------------------
# Phase 8d: mixed precision (SolveConfig.precision, ROADMAP A15a)
# ---------------------------------------------------------------------------

# (a) the reference's precision problem (tests/test_precision.py:28-37:
# d 5, gaussian sigma 2, jitter 1e-4, rank 16, leaf 32) at n 4,096 (7
# levels), float64 data; its gates against the f64 build
# (tests/test_precision.py:20), (Gram-family factors, matvec and
# predictions), the f32 solve at ridge 1e-2 (5e-3) and the bf16 solve at
# the ridge floor 1e-1 (1e-1)
PREC_N, PREC_D, PREC_LEVELS, PREC_RANK = 4096, 5, 7, 16
PREC_SIGMA, PREC_JITTER = 2.0, 1e-4
PREC_GATES = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 5e-2)}
PREC_F32_SOLVE, PREC_F32_SOLVE_GATE = 1e-2, 5e-3
PREC_FLOOR_RIDGE, PREC_FLOOR_GATE = 1e-1, 1e-1
# (b)-(d), (f): covtype width under bf16 at the launcher's convention
# (jitter 1e-4, lambda 1e-1: the reference's bf16 ridge floor)
BF16_JITTER, BF16_LAM = 1e-4, 1e-1
# (e): a bf16 fit of (a)'s problem at lambda 1e-4, probes on
FLOOR_LAM = 1e-4
# the kernels of the bfloat16-data entries: (record name, count key,
# source, TPU kernel)
BF16_RECORDS = (
    ("gram_chol (bf16 data)", ("gram_chol_bf16", "gram_chol_levels_bf16"),
     "build_stage.cu", "build_stage/build_stage.py:124"),
    ("cross_solve (bf16 data)", ("cross_solve_bf16",
                                 "cross_solve_levels_bf16"),
     "build_stage.cu", "build_stage/build_stage.py:157"),
    ("oos_contract (bf16 data)", ("oos_contract_bf16",),
     "oos_contract.cu", "oos_stage/oos_stage.py:64"),
    ("gram_chol_dist (bf16 data)", ("gram_chol_dist_bf16",
                                    "gram_chol_dist_levels_bf16"),
     "build_dist.cu", "build_stage/build_stage.py:215"),
    ("cross_solve_dist (bf16 data)", ("cross_solve_dist_bf16",
                                      "cross_solve_dist_levels_bf16"),
     "build_dist.cu", "build_stage/build_stage.py:254"))


def rel_gap(a, b) -> float:
    """||a - b|| / ||b|| in float64 (the reference's precision gates)."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def gram_family(f) -> list:
    """Adiag, every Sigma and every Cholesky factor of Sigma."""
    return [f.adiag, *f.sigma, *f.sigma_cho]


def factor_gap(f, ref) -> float:
    """The largest relative norm gap of the Gram-family factors."""
    return max(rel_gap(a, b) for a, b in zip(gram_family(f),
                                              gram_family(ref)))


def bf16(t):
    """``t`` as a mixed-precision policy's data: bfloat16."""
    return t.to(torch.bfloat16)


def precision_bounds(dev) -> dict:
    """Phase 8d (a): (a)'s problem built under each policy on one tree and
    one landmark set (drawn in float64 before any cast), against the f64
    build: "f64" bit for bit, f32 and bf16 within the reference's gates
    (factors, matvec, predictions of the f64 model under the policy), the
    f32 solve at ridge 1e-2 and the bf16 solve at the ridge floor."""
    from repro_torch.core import hck, hmatrix, oos
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.registry import SolveConfig

    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    o = dict(generator=gen, device=dev, dtype=torch.float64)
    x = torch.randn((PREC_N, PREC_D), **o)
    b = torch.randn((PREC_N, 2), **o)
    w = torch.randn((PREC_N, 2), **o)
    q = torch.randn((1024, PREC_D), **o)
    ker = BaseKernel("gaussian", PREC_SIGMA, PREC_JITTER)

    def build(prec):
        return hck.build_hck(
            x, levels=PREC_LEVELS, rank=PREC_RANK, kernel=ker,
            config=SolveConfig(precision=prec),
            generator=torch.Generator(device=dev).manual_seed(SEED + 42))

    f = {p: build(p) for p in (None, "f64", "f32", "bf16")}
    ref = f[None]
    same = all(torch.equal(a, c) for a, c in zip(
        gram_family(f["f64"]) + [f["f64"].u, *f["f64"].w],
        gram_family(ref) + [ref.u, *ref.w]))
    require(same, "the f64 policy equals the f64 build bit for bit")
    plan = oos.prepare(ref, w)
    out = {}
    for prec in ("f32", "bf16"):
        ftol, otol = PREC_GATES[prec]
        fe, mv, pe = out[prec] = policy_gap(f[prec], ref, plan, q, ker, b,
                                            prec)
        say(f"[8d precision] (a) {prec} policy, n {PREC_N} d {PREC_D} "
            f"leaf {ref.leaf_size} r {PREC_RANK}, against the f64 build: "
            f"Gram-family factors {fe:.3e} (gate {ftol:g}), matvec "
            f"{mv:.3e}, predictions of the f64 model under the policy "
            f"{pe:.3e} (gate {otol:g}) ok")
    z32 = hmatrix.solve(f["f32"], b.float(), ridge=PREC_F32_SOLVE)
    s32 = rel_gap(z32, hmatrix.solve(ref, b, ridge=PREC_F32_SOLVE))
    zbf = hmatrix.solve(f["bf16"], b.float(), ridge=PREC_FLOOR_RIDGE)
    sbf = rel_gap(zbf, hmatrix.solve(ref, b, ridge=PREC_FLOOR_RIDGE))
    require(bool(torch.isfinite(z32).all()) and s32 <= PREC_F32_SOLVE_GATE,
            f"f32 solve at ridge {PREC_F32_SOLVE:g}: {s32:.3e}")
    require(bool(torch.isfinite(zbf).all()) and sbf <= PREC_FLOOR_GATE,
            f"bf16 solve at ridge {PREC_FLOOR_RIDGE:g}: {sbf:.3e}")
    say(f"[8d precision] (a) f64 policy = f64 build bit for bit; f32 solve "
        f"at ridge {PREC_F32_SOLVE:g} {s32:.3e} (gate "
        f"{PREC_F32_SOLVE_GATE:g}), bf16 solve at the ridge floor "
        f"{PREC_FLOOR_RIDGE:g} finite, {sbf:.3e} (gate {PREC_FLOOR_GATE:g}) "
        "ok")
    out["solves"] = (s32, sbf)
    return out


def policy_gap(fp, ref, plan, q, ker, b, prec) -> tuple:
    """A build under policy ``prec`` against the f64 build ``ref`` on its
    tree and landmarks, within PREC_GATES: its Gram-family factors, its
    matvec of ``b`` and the f64 model's predictions of ``q`` (``plan``)
    under the policy.  (factors, matvec, predictions) gaps."""
    from repro_torch.core import hmatrix, oos
    from repro_torch.kernels.registry import SolveConfig

    ftol, otol = PREC_GATES[prec]
    require(torch.equal(fp.tree.perm, ref.tree.perm) and all(
        torch.equal(a, c) for a, c in zip(fp.landmarks, ref.landmarks)),
        f"{prec}: the tree and the landmarks of the f64 build")
    fe = factor_gap(fp, ref)
    mv = rel_gap(hmatrix.matvec(fp, b.float()), hmatrix.matvec(ref, b))
    pe = rel_gap(oos.apply_plan(ref, plan, q, ker,
                                SolveConfig(precision=prec)),
                 oos.apply_plan(ref, plan, q, ker))
    require(fe <= ftol and mv <= otol and pe <= otol,
            f"{prec} (n0 {ref.leaf_size}, r {ref.rank}) against the f64 "
            f"build: factors {fe:.3e} <= {ftol}, matvec {mv:.3e} and "
            f"predictions {pe:.3e} <= {otol}")
    return fe, mv, pe


def bf16_fit_args(args):
    """fit_launches' B1 and B2 arguments with the data (points, landmarks)
    in bfloat16 and Linv in float32, as the bf16 policy launches them."""
    return ([(bf16(p), want) for p, want in args["gram"]],
            [(bf16(p), bf16(z), li) for p, z, li in args["cross"]])


def bf16_bucket(local, walk, pair):
    """bucket_inputs with the data (points, landmarks, queries) in
    bfloat16 and the weights in float32."""
    local = (bf16(local[0]), local[1], bf16(local[2]), *local[3:])
    walk = (bf16(walk[0]), walk[1], bf16(walk[2]), *walk[3:])
    pair = (bf16(pair[0]), pair[1], bf16(pair[2]), pair[3], bf16(pair[4]),
            *pair[5:])
    return local, walk, pair


def offset_view(t):
    """A contiguous copy of ``t`` whose data start one element past an
    allocation's start (for bfloat16: 2 bytes off every 4-byte boundary)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def bf16_kernel_shapes(dev) -> None:
    """Phase 8d, small shapes: every bfloat16-data entry (B1 with and
    without factors, B2, B7 one stage and both terms, B8 with factors and
    gram_dist, B9) against its plain version at d 3, 7, 18 and 54 (rows of
    6, 14, 36 and 108 bytes), ragged groups, every data tensor a view
    offset by one element; B7 also with the laplace kernel (L1) and in
    chunks of rows.  The f32 gates of phase 4."""
    from repro_torch.kernels.build_stage.ops import (build_cross_dist_levels,
                                                     build_cross_levels,
                                                     build_gram_dist,
                                                     build_gram_dist_levels,
                                                     build_gram_levels)
    from repro_torch.kernels.build_stage.ref import direct_dist

    gen = torch.Generator(device=dev).manual_seed(SEED + 45)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def linv_of(b, r):
        a = rnd(b, r, r)
        chol = torch.linalg.cholesky(a @ a.mT / r + torch.eye(r, device=dev))
        return torch.linalg.solve_triangular(
            chol, torch.eye(r, device=dev).expand(b, r, r),
            upper=False).contiguous()

    worst = {}
    for d in (3, 7, 18, 54):
        sc = math.sqrt(2.0 / d)
        pts = [offset_view(bf16(rnd(2, 37, d, scale=sc))),
               offset_view(bf16(rnd(4, 16, d, scale=sc)))]
        grams = build_gram_levels(pts, sigma=SIGMA, jitter=1e-3)
        e1 = [check_build(p, True, 1e-4, jitter=1e-3, got=g)[0]
              for p, g in zip(pts, grams)]
        e1 += [check_build(p, False, 1e-4, jitter=1e-3, got=g)[0]
               for p, g in zip(pts, build_gram_levels(
                   pts, sigma=SIGMA, jitter=1e-3, want_chol=False))]
        cross = [(offset_view(bf16(rnd(3, 50, d, scale=sc))),
                  offset_view(bf16(rnd(3, 24, d, scale=sc))), linv_of(3, 24)),
                 (offset_view(bf16(rnd(2, 9, d, scale=sc))),
                  offset_view(bf16(rnd(2, 24, d, scale=sc))), linv_of(2, 24))]
        us = build_cross_levels(*zip(*cross), sigma=SIGMA)
        e2 = [check_cross(a, None, got=u)[0] for a, u in zip(cross, us)]
        xl = offset_view(bf16(rnd(8, 40, d, scale=sc)))
        wl, ct = rnd(8, 40, 3), rnd(8, 24, 3)
        lm = offset_view(bf16(rnd(4, 24, d, scale=sc)))
        qs = offset_view(bf16(rnd(100, d, scale=sc)))
        leaf = torch.sort(torch.randint(0, 8, (100,), generator=gen,
                                        device=dev)).values
        e7 = []
        for name, block in (("gaussian", None), ("laplace", None),
                            ("gaussian", 16)):
            e7.append(check_contract((xl, wl, lm, ct, qs, leaf, leaf >> 1),
                                     name=name, rtol=1e-4, pair=True,
                                     leaf_block=block)[0])
            e7.append(check_contract((xl, wl, qs, leaf, leaf), name=name,
                                     rtol=1e-4, leaf_block=block)[0])
        dp = [rnd(2, 37, d, scale=sc), rnd(3, 21, d, scale=sc)]
        tiles = [offset_view(bf16(direct_dist(p, p, "l2"))) for p in dp]
        e8 = [check_gram_dist(t, g, 1e-4, jitter=1e-3)[0] for t, g in zip(
            tiles, build_gram_dist_levels(tiles, sigma=SIGMA, jitter=1e-3))]
        e8.append(check_gram_dist(tiles[0], build_gram_dist(
            tiles[0], sigma=SIGMA, jitter=1e-3, want_chol=False), 1e-4,
            jitter=1e-3)[0])
        cd = [(offset_view(bf16(direct_dist(rnd(3, 50, d, scale=sc),
                                            rnd(3, 24, d, scale=sc), "l2"))),
               linv_of(3, 24))]
        e9 = [check_cross_dist(t, li, u, None)[0] for (t, li), u in zip(
            cd, build_cross_dist_levels(*zip(*cd), sigma=SIGMA))]
        worst[d] = {"B1": max(e1), "B2": max(e2), "B7": max(e7),
                    "B8": max(e8), "B9": max(e9)}
    say("[8d precision] bf16-data entries at small shapes, data views offset "
        "by one element, against their plain versions (phase 4's f32 "
        "gates; largest rel per kernel): " + "; ".join(
            f"d {d}: " + ", ".join(f"{k} {v:.2e}" for k, v in w.items())
            for d, w in worst.items()) + " ok")


def precision_fit(fit, dev) -> dict:
    """Phase 8d (b): the covtype-width bf16 krr.fit (launch counts read
    around exactly this call), warm again, and an f32 fit of the same
    settings on the same tree and landmarks; their gaps; the ladder's
    verdict on the bf16 fit's inversion; every bf16 launch of the fit
    (B1, B2) and of a serving bucket (B7) against its plain version on the
    same bf16 inputs, at the f32 gates."""
    from repro_torch.core import krr
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.build_stage.ops import (build_cross_levels,
                                                     build_gram,
                                                     build_gram_levels)
    from repro_torch.kernels.registry import SolveConfig
    from repro_torch.runtime import recover

    x, labels, xt, yt = fit["x"], fit["labels"], fit["xt"], fit["yt"]
    ker = BaseKernel("gaussian", SIGMA, BF16_JITTER)
    cfg = SolveConfig(precision="bf16")
    opts = dict(kernel=ker, lam=BF16_LAM, rank=RANK, leaf_size=LEAF,
                classification=True)

    def gen():
        return torch.Generator(device=dev).manual_seed(SEED + 1)

    sync()
    torch.cuda.reset_peak_memory_stats()
    # ---- the bf16 fit: counts set to 0 just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    m16 = krr.fit(x, labels, generator=gen(), solve_config=cfg, **opts)
    sync()
    t_first = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated() / 2**30
    bf16_fit = {"gram_chol_bf16": 1, "gram_chol_levels_bf16": 1,
                "cross_solve_levels_bf16": 1}
    require_launches("the bf16 krr.fit", launches, plain_calls,
                     dict(FIT_LAUNCHES, **bf16_fit))
    t0 = time.perf_counter()
    again = krr.fit(x, labels, generator=gen(), solve_config=cfg, **opts)
    sync()
    t_warm = time.perf_counter() - t0
    same = torch.equal(again.alpha, m16.alpha)
    del again
    t0 = time.perf_counter()
    m32 = krr.fit(x, labels, generator=gen(), **opts)
    sync()
    t_f32 = time.perf_counter() - t0
    f16, f32 = m16.factors, m32.factors
    require(torch.equal(f16.tree.perm, f32.tree.perm) and all(
        torch.equal(a, c) for a, c in zip(f16.landmarks, f32.landmarks)),
        "the bf16 and f32 fits share their tree and landmarks")
    require(f16.u.dtype == m16.alpha.dtype == torch.float32
            and bool(torch.isfinite(m16.alpha).all()),
            "the bf16 fit's factors and alpha are finite float32")
    z16, z32 = m16.predict(xt), m32.predict(xt)
    gaps = {"gram-family factors": factor_gap(f16, f32),
            "U": rel_gap(f16.u, f32.u), "alpha": rel_gap(m16.alpha,
                                                           m32.alpha),
            "predictions": rel_gap(z16, z32)}
    acc16 = float((m16.predict_class(xt) == yt).double().mean())
    acc32 = float((m32.predict_class(xt) == yt).double().mean())
    say(f"[8d precision] (b) bf16 krr.fit n={N_TRAIN} -> {f16.n} d={D} "
        f"r={RANK} leaf={LEAF} sigma={SIGMA} lam={BF16_LAM} "
        f"jitter={BF16_JITTER}: first call {t_first:.3f} s, warm "
        f"{t_warm:.3f} s (alpha bit for bit the first's: {same}), peak "
        f"device memory {peak:.2f} GiB; the f32 fit of the same settings "
        f"{t_f32:.3f} s (warm)")
    say(f"[8d precision] (b) launches on the bf16 fit path: "
        f"{ {k: v for k, v in launches.items() if v} } (exact); no plain "
        f"version called")
    say("[8d precision] (b) bf16 against the f32 fit on the same tree and "
        "landmarks (relative norms, not gated): " + ", ".join(
            f"{k} {v:.3e}" for k, v in gaps.items())
        + f"; test accuracy bf16 {acc16:.4f}, f32 {acc32:.4f}")
    g = recover.invert_guarded(f16, BF16_LAM, cfg, kernel=ker,
                               jitter_rungs=0)
    say(f"[8d precision] (b) recover.invert_guarded on the bf16 fit's "
        f"factors at lambda {BF16_LAM:g} (n0 {LEAF}: n0 eps_bf16 = "
        f"{LEAF * 2.0 ** -7:.2f}): rungs {g.audit.rungs}, held on "
        f"'{g.audit.rungs[-1]}'")
    require(g.audit.ok, "the bf16 fit's inversion holds on a rung")

    # each bf16 launch against its plain version on the same bf16 inputs
    res = {}
    args = fit_launches(f16, m16.inverse, m16.alpha.view(
        f16.num_leaves, LEAF, N_CLASSES))
    gram16, cross16 = bf16_fit_args(args)
    pts = [p for p, _ in gram16]
    grams = build_gram_levels(pts[:-1], sigma=SIGMA, jitter=BF16_JITTER)
    grams.append(build_gram(pts[-1], sigma=SIGMA, jitter=BF16_JITTER,
                            want_chol=False))
    errs = [check_build(p, want, 1e-4, jitter=BF16_JITTER, got=gr)
            for (p, want), gr in zip(gram16, grams)]
    res["gram_chol"] = max(e[1] for e in errs)
    us = build_cross_levels(*zip(*cross16), sigma=SIGMA)
    errs2 = [check_cross(a, None, got=u) for a, u in zip(cross16, us)]
    res["cross_solve"] = max(e[1] for e in errs2)
    local, walk, pair = bf16_bucket(*bucket_inputs(f16, m16.plan,
                                                   xt[:4096]))
    cerr = {}
    for stage, a, both in (("oos_local", local, False),
                           ("oos_walk", walk, False),
                           ("oos_local_walk", pair, True)):
        cerr[stage] = check_contract(a, name="gaussian", rtol=1e-4,
                                     pair=both)[0]
    res["oos_contract"] = cerr["oos_local_walk"]
    say(f"[8d precision] (b) bf16-data entries against their plain versions "
        f"on the same bf16 inputs (f32 gates): gram_chol_levels_bf16 "
        f"({LEVELS} Sigma levels and the Adiag) rel "
        f"{max(e[0] for e in errs):.3e}, max|d| {res['gram_chol']:.3e} "
        f"(1e-4); cross_solve_levels_bf16 (U and {LEVELS - 1} W levels) rel "
        f"{max(e[0] for e in errs2):.3e}, max|d| {res['cross_solve']:.3e} "
        f"(componentwise 4 (2r + d) eps |K||Linv^T||Linv|); "
        f"oos_contract_bf16 on a 4096-query bucket: oos_local "
        f"{cerr['oos_local']:.3e}, oos_walk {cerr['oos_walk']:.3e}, both "
        f"in one launch {cerr['oos_local_walk']:.3e} (max|dz|, 1e-4 of "
        f"max|z|) ok")
    return {"m16": m16, "m32": m32, "launches": launches, "res": res,
            "args32": fit_launches(f32, m32.inverse, m32.alpha.view(
                f32.num_leaves, LEAF, N_CLASSES)),
            "args16": (gram16, cross16), "bucket16": pair,
            "bucket32": bucket_inputs(f32, m32.plan, xt[:4096])[2],
            "t_first": t_first, "t_warm": t_warm, "peak": peak,
            "gaps": gaps}


def precision_sweep(sw, dev) -> dict:
    """Phase 8d (c): one sigma of sweep_factors in bf16 on phase 7's
    covtype-width plan (launch counts read around exactly this call), B8
    and B9 against their plain versions on the same bf16 tiles, the gaps
    to the f32 sweep at that sigma (the tiles themselves are rounded to
    bf16, the reference's semantics: printed, not gated).  At the bf16
    convention's jitter 1e-4: rounded distances are no Gram of any
    points, and at phase 7's 1e-5 the pad rows' near-duplicate landmarks
    leave some Sigma tiles indefinite under that rounding (a build from
    rounded points keeps every Gram positive semi-definite)."""
    from repro_torch.core import hck
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.build_stage.ops import (build_cross_dist_levels,
                                                     build_gram_dist,
                                                     build_gram_dist_levels)
    from repro_torch.kernels.registry import SolveConfig

    plan = sw["plan"]
    ker = BaseKernel("gaussian", SIGMA, BF16_JITTER)
    cfg = SolveConfig(precision="bf16")
    f16, launches, plain_calls = counted(lambda: hck.sweep_factors(
        plan, ker, cfg))
    require_launches("one bf16 sigma of sweep_factors", launches,
                     plain_calls, {
                         "gram_chol_dist_levels": 1, "gram_chol_dist": 1,
                         "cross_solve_dist_levels": 1,
                         "gram_chol_dist_levels_bf16": 1,
                         "gram_chol_dist_bf16": 1,
                         "cross_solve_dist_levels_bf16": 1})
    f32 = hck.sweep_factors(plan, ker)
    gaps = {"gram-family factors": factor_gap(f16, f32),
            "U": rel_gap(f16.u, f32.u)}
    args = sweep_launches(plan, f16)
    sig16 = [bf16(d) for d in args["sigma"]]
    adiag16 = bf16(args["adiag"])
    cross16 = [(bf16(d), li) for d, li in args["cross"]]
    grams = build_gram_dist_levels(sig16, sigma=SIGMA, jitter=BF16_JITTER)
    errs = [check_gram_dist(d, g, 1e-4, jitter=BF16_JITTER)
            for d, g in zip(sig16, grams)]
    errs.append(check_gram_dist(adiag16, build_gram_dist(
        adiag16, sigma=SIGMA, jitter=BF16_JITTER, want_chol=False), 1e-4,
        jitter=BF16_JITTER))
    us = build_cross_dist_levels(*zip(*cross16), sigma=SIGMA)
    errs9 = [check_cross_dist(d, li, u, None)
             for (d, li), u in zip(cross16, us)]
    res = {"gram_chol_dist": max(e[1] for e in errs),
           "cross_solve_dist": max(e[1] for e in errs9)}
    say(f"[8d precision] (c) one bf16 sigma ({SIGMA}, jitter {BF16_JITTER:g})"
        f" of sweep_factors at covtype width: launches "
        f"{ {k: v for k, v in launches.items() if v} } (exact); no plain "
        "version called")
    say(f"[8d precision] (c) gram_chol_dist_levels_bf16 ({LEVELS} Sigma "
        f"levels) and gram_dist_bf16 (Adiag) against plain: rel "
        f"{max(e[0] for e in errs):.3e}, max|d| {res['gram_chol_dist']:.3e}"
        f" (1e-4); cross_solve_dist_levels_bf16 (U and {LEVELS - 1} W "
        f"levels): rel {max(e[0] for e in errs9):.3e}, max|d| "
        f"{res['cross_solve_dist']:.3e} (componentwise 4 (2r + 1) eps "
        "|K||Linv^T||Linv|) ok")
    say("[8d precision] (c) bf16 sweep against the f32 sweep at this sigma "
        "(bf16 distance tiles; not gated): " + ", ".join(
            f"{k} {v:.3e}" for k, v in gaps.items()))
    return {"launches": launches, "res": res, "gaps": gaps,
            "args16": (sig16, adiag16, cross16), "args32": args}


def serve_requests(eng, xt, sizes) -> list:
    """Latencies (s) of one request a size, consecutive test queries."""
    lat, start = [], 0
    for s in sizes:
        t = time.perf_counter()
        eng(xt[start:start + s])
        sync()
        lat.append(time.perf_counter() - t)
        start += s
    return lat


def percentile_ms(lat, pct) -> float:
    """The pct-th percentile of ``lat`` (seconds) in ms, as phase 6 reads
    it."""
    s = sorted(lat)
    return s[min(len(s) - 1, math.ceil(pct / 100 * len(s)) - 1)] * 1e3


def precision_serving(pf, fit) -> dict:
    """Phase 8d (d): the bf16 model behind its PredictEngine on all 116,203
    test queries (launch counts read around exactly this request) against
    the f32 model of the same settings: queries/s, p50/p99 over phase 6's
    16 requests (engines in turns), the largest prediction gap, and the
    device ops of one 4096-query request (the stacks are cast once, when
    the engine is built: a bf16 request casts only its queries)."""
    xt = fit["xt"]
    sizes = [1, 3, 7, 16, 33, 64, 100, 128, 257, 512, 700, 1024, 1500, 2048,
             3000, 4096]
    e16, e32 = pf["m16"].engine, pf["m32"].engine
    for eng in (e16, e32):
        eng.warmup()
    stacks = e16._stacks
    require(stacks[0].dtype == stacks[2].dtype == torch.bfloat16
            and stacks[1].dtype == stacks[3].dtype == torch.float32,
            "the bf16 engine keeps bf16 points and landmarks, f32 weights")
    ptrs = [t.data_ptr() for t in stacks]
    z16, launches, plain_calls = counted(lambda: e16(xt))
    buckets = -(-N_TEST // 4096)
    require_launches("the bf16 engine on all test queries", launches,
                     plain_calls, {"oos_contract": buckets,
                                   "oos_contract_pair": buckets,
                                   "oos_contract_bf16": buckets})
    require([t.data_ptr() for t in e16._stacks] == ptrs,
            "the bf16 engine served from the stacks it cast once")
    z32 = e32(xt)
    gap = rel_max(z16, z32)
    times = {}
    for tag, eng in (("bf16", e16), ("f32", e32), ("f32", e32),
                     ("bf16", e16)):
        t = time.perf_counter()
        eng(xt)
        sync()
        times.setdefault(tag, []).append(time.perf_counter() - t)
    lat = {"bf16": [], "f32": []}
    for tag, eng in (("bf16", e16), ("f32", e32), ("f32", e32),
                     ("bf16", e16)):
        lat[tag] += serve_requests(eng, xt, sizes)
    ops = {tag: device_ops(lambda eng=eng: eng(xt[:4096]))
           for tag, eng in (("bf16", e16), ("f32", e32))}
    if not math.isnan(ops["bf16"][1]):
        require(ops["bf16"][1] <= ops["f32"][1] + 1,
                f"a bf16 request runs at most one device op more than an "
                f"f32 one (the cast of its queries): {ops}")
    qps = {k: N_TEST / statistics.mean(v) for k, v in times.items()}
    pct = {k: (percentile_ms(v, 50), percentile_ms(v, 99))
           for k, v in lat.items()}
    say(f"[8d precision] (d) bf16 engine on all {N_TEST} test queries: "
        f"launches {launches['oos_contract']} (one a bucket, all "
        f"oos_contract_bf16, both terms) exact, no plain version called; "
        f"largest prediction gap to the f32 engine (rel to max|z|) "
        f"{gap:.3e}")
    say(f"[8d precision] (d) queries/s over all test queries (mean of two, "
        f"in turns): bf16 {qps['bf16']:.0f}, f32 {qps['f32']:.0f}; 16 "
        f"requests of sizes 1..4096 twice each (in turns): bf16 p50 "
        f"{pct['bf16'][0]:.3f} ms p99 {pct['bf16'][1]:.3f} ms, f32 p50 "
        f"{pct['f32'][0]:.3f} ms p99 {pct['f32'][1]:.3f} ms (of 32)")
    say(f"[8d precision] (d) one 4096-query request under torch.profiler: "
        f"bf16 {ops['bf16'][1]:.0f} device ops {ops['bf16'][0]:.4f} ms, "
        f"f32 {ops['f32'][1]:.0f} device ops {ops['f32'][0]:.4f} ms (the "
        "stacks cast once at engine build; a request casts its queries)")
    return {"launches": launches, "qps": qps, "pct": pct, "gap": gap,
            "ops": ops}


def precision_floor(dev) -> dict:
    """Phase 8d (e): the ridge floor.  A bf16 fit of (a)'s problem (float32
    data) at lambda 1e-4 with probes on; its factors through
    recover.invert_guarded (the audit printed: the port's kernels write
    float32 factors, whose only bf16 error is the data's rounding).  Then
    the bf16_ridge_floor injector on the same problem (its factors rounded
    to bf16 as the reference's xla lane stores them, at the problem's
    jitter 1e-4: at the injector's default 1e-6 the HCK operator itself
    leaves lambda 1e-4 no accurate solve): the probe detects the
    indefinite leaf and the promotion rung recovers at the original ridge,
    its solve's residual on a float64 copy of the recovered factors within
    1e-2 (the reference's gate)."""
    from repro_torch.core import hck, hmatrix, krr
    from repro_torch.core.kernels_fn import BaseKernel
    from repro_torch.kernels.registry import SolveConfig
    from repro_torch.runtime import health, recover
    from repro_torch.testing import faultinject as fi

    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    x = torch.randn((PREC_N, PREC_D), generator=gen, device=dev)
    y = torch.sin(x[:, 0]) + 0.25 * torch.cos(2.0 * x[:, 1])
    ker = BaseKernel("gaussian", PREC_SIGMA, PREC_JITTER)
    cfg = SolveConfig(precision="bf16", checks=True)
    build = dict(levels=PREC_LEVELS, rank=PREC_RANK)

    def draws():
        return torch.Generator(device=dev).manual_seed(SEED + 44)

    try:
        m = krr.fit(x, y, kernel=ker, lam=FLOOR_LAM, rank=PREC_RANK,
                    leaf_size=PREC_N >> PREC_LEVELS, levels=PREC_LEVELS,
                    solve_config=cfg, generator=draws())
        fit_note = (f"held (alpha finite: "
                    f"{bool(torch.isfinite(m.alpha).all())})")
    except health.NumericalFailure as e:
        fit_note = f"detected: {e.stage} {e.statistic}"
    f = hck.build_hck(x, kernel=ker, config=cfg, generator=draws(), **build)
    g = recover.invert_guarded(f, FLOOR_LAM, cfg, kernel=ker,
                               jitter_rungs=0)
    require(g.audit.ok, f"bf16 factors at lambda {FLOOR_LAM:g}: the ladder "
            f"holds ({g.audit.rungs})")
    say(f"[8d precision] (e) bf16 krr.fit of (a)'s problem at lambda "
        f"{FLOOR_LAM:g} (n0 {PREC_N >> PREC_LEVELS}, jitter {PREC_JITTER:g}) "
        f"with probes on: {fit_note}; recover.invert_guarded on its factors: "
        f"rungs {g.audit.rungs}")
    bad, ker16, cfg16 = fi.bf16_ridge_floor_factors(
        x, kernel=ker, jitter=PREC_JITTER, config=SolveConfig(checks=True),
        generator=draws(), **build)
    require(health.probe_factors(bad, cfg16), "the injected bf16 build is "
            "finite")
    _, lo = hmatrix.invert_with_leaf(bad, FLOOR_LAM, cfg16)
    try:
        health.probe_leaf_factor(lo, cfg16)
        detected = None
    except health.NumericalFailure as e:
        detected = e
    require(detected is not None and detected.stage == "leaf_factor",
            "the probe detects the bf16_ridge_floor fault in leaf_factor")
    g2 = recover.invert_guarded(bad, FLOOR_LAM, cfg16, kernel=ker16,
                                jitter_rungs=0)
    require(g2.audit.ok and not g2.audit.attempts[0].ok
            and g2.audit.rungs[-1] == "promote:f32"
            and g2.ridge == FLOOR_LAM,
            f"the promotion rung recovers at the original ridge: "
            f"{g2.audit.rungs}, ridge {g2.ridge}")
    yb = y[g2.factors.tree.perm][:, None]
    alpha = hmatrix.solve_with_inverse(g2.factors, g2.inverse, yb,
                                       ridge=g2.ridge, config=g2.config)
    # the residual on a float64 copy of the recovered factors
    f64 = recover._cast_float(g2.factors, torch.float64)
    a64 = alpha.double()
    resid = rel_gap(hmatrix.matvec(f64, a64) + FLOOR_LAM * a64, yb)
    require(bool(torch.isfinite(alpha).all()) and resid <= 1e-2,
            f"the recovered solve: finite, residual {resid:.3e} <= 1e-2")
    say(f"[8d precision] (e) bf16_ridge_floor injected (jitter "
        f"{ker16.jitter:g}, factors rounded to bf16): the probe detected "
        f"'{detected.stage}' ({detected.statistic}); invert_guarded rungs "
        f"{g2.audit.rungs} at ridge {g2.ridge:g}, config precision "
        f"{g2.config.precision}; recovered solve residual {resid:.3e} "
        "(1e-2) ok")
    return {"rungs": g.audit.rungs, "injected": g2.audit.rungs}


def precision_launcher(dev) -> dict:
    """Phase 8d (f): launch.train --task krr --precision bf16 at covtype's
    padded size and width, and --precision f64 at n 65,536, in process;
    each printed line and launch count checked."""
    num = r"[0-9.]+"
    one_bucket = {"oos_contract": 1, "oos_contract_pair": 1}
    runs = {}
    line = (r"krr n={n} d={d} rank={r} backend=auto \(in-memory\): fit "
            rf"{num} s \([0-9,]+ points/s\), train rel-err {num}")
    runs["bf16"] = launcher_mode(
        ["--task", "krr", "--n", str(LAUNCH_N), "--d", str(D), "--rank",
         str(RANK), "--precision", "bf16"],
        dict(FIT_LAUNCHES, **one_bucket, gram_chol_bf16=1,
             gram_chol_levels_bf16=1, cross_solve_levels_bf16=1,
             oos_contract_bf16=1),
        [line.format(n=LAUNCH_N, d=D, r=RANK)], tag="[8d precision] (f)")
    runs["f64"] = launcher_mode(
        ["--task", "krr", "--n", str(LAUNCH_SMALL_N), "--rank", str(RANK),
         "--precision", "f64"], dict(FIT_LAUNCHES, **one_bucket),
        [line.format(n=LAUNCH_SMALL_N, d=8, r=RANK)],
        tag="[8d precision] (f)")
    for mode, dt in (("bf16", torch.float32), ("f64", torch.float64)):
        m = runs[mode]["model"]
        require(runs[mode]["precision"] == mode
                and m.solve_config.precision == mode
                and m.alpha.dtype == dt and m.factors.u.dtype == dt,
                f"--precision {mode}: the model's policy and factor dtype")
    require(runs["bf16"]["model"].lam == BF16_LAM
            and runs["bf16"]["model"].kernel.jitter == BF16_JITTER,
            "--precision bf16 at lambda 1e-1 and jitter 1e-4")
    return runs


def bf16_timing(pf, ps) -> list[dict]:
    """Phase 8d, timing: B1, B2 and B7 of the fit and a serving bucket,
    B8 and B9 of one sweep sigma, each bf16-data entry in turns with its
    f32 entry on the same shapes (bf16, f32, f32, bf16; events around
    calls for B1, B2, B8 and B9, device time for B7, as phase 9 times
    them), beside its plain version and its bound (bfloat16 data counted
    at 2 bytes)."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.build_stage import ref as bref
    from repro_torch.kernels.oos_stage import ops as oops
    from repro_torch.kernels.oos_stage import ref as oref

    gram16, cross16 = pf["args16"]
    a32 = pf["args32"]
    p16 = [p for p, _ in gram16]
    p32 = [p for p, _ in a32["gram"]]
    go = dict(sigma=SIGMA, jitter=BF16_JITTER)

    def gram_fn(ps):
        return lambda: (bops.build_gram_levels(ps[:-1], **go),
                        bops.build_gram(ps[-1], want_chol=False, **go))

    gc = [gram_cost(p, w) for p, (_, w) in zip(p16, gram16)]
    cross32 = a32["cross"]
    cc = sum(cross_cost(*a)[0] for a in cross16)
    shapes = [a[0].shape[:2] + a[1].shape[1:2] for a in cross16]
    pair16, pair32 = pf["bucket16"], pf["bucket32"]
    sig16, adiag16, cross_d16 = ps["args16"]
    s32 = ps["args32"]

    rows = []
    turns = {
        "gram_chol (bf16 data)": in_turns(gram_fn(p16), gram_fn(p32), 5),
        "cross_solve (bf16 data)": in_turns(
            lambda: bops.build_cross_levels(*zip(*cross16), sigma=SIGMA),
            lambda: bops.build_cross_levels(*zip(*cross32), sigma=SIGMA), 5),
        "oos_contract (bf16 data)": in_turns(
            lambda: oops.oos_local_walk(*pair16, sigma=SIGMA),
            lambda: oops.oos_local_walk(*pair32, sigma=SIGMA), 50,
            device=True),
        "gram_chol_dist (bf16 data)": in_turns(
            lambda: (bops.build_gram_dist_levels(sig16, **go),
                     bops.build_gram_dist(adiag16, want_chol=False, **go)),
            lambda: (bops.build_gram_dist_levels(s32["sigma"], **go),
                     bops.build_gram_dist(s32["adiag"], want_chol=False,
                                          **go)), 5),
        "cross_solve_dist (bf16 data)": in_turns(
            lambda: bops.build_cross_dist_levels(*zip(*cross_d16),
                                                 sigma=SIGMA),
            lambda: bops.build_cross_dist_levels(*zip(*s32["cross"]),
                                                 sigma=SIGMA), 5)}
    plain = {
        "gram_chol (bf16 data)": time_ms(
            lambda: (bref.build_gram_levels_ref(p16[:-1], **go),
                     bref.build_gram_ref(p16[-1], want_chol=False, **go)),
            3),
        "cross_solve (bf16 data)": time_ms(
            lambda: bref.build_cross_levels_ref(*zip(*cross16), sigma=SIGMA),
            3),
        "oos_contract (bf16 data)": time_ms(
            lambda: oref.oos_local_walk_ref(*pair16, sigma=SIGMA), 20),
        "gram_chol_dist (bf16 data)": time_ms(
            lambda: (bref.build_gram_dist_levels_ref(sig16, **go),
                     bref.build_gram_dist_ref(adiag16, want_chol=False,
                                              **go)), 3),
        "cross_solve_dist (bf16 data)": time_ms(
            lambda: bref.build_cross_dist_levels_ref(*zip(*cross_d16),
                                                     sigma=SIGMA), 3)}
    gdc = [gram_dist_cost(d, True) for d in sig16] + [
        gram_dist_cost(adiag16, False)]
    bounds = {
        "gram_chol (bf16 data)": bound_ms(sum(c[0] for c in gc),
                                          sum(c[1] for c in gc)),
        "cross_solve (bf16 data)": cross_tc_bound(cc, shapes),
        "oos_contract (bf16 data)": bound_ms(*pair_cost(*pair16)),
        "gram_chol_dist (bf16 data)": bound_ms(sum(c[0] for c in gdc),
                                               sum(c[1] for c in gdc)),
        "cross_solve_dist (bf16 data)": cross_dist_tc_bound(cross_d16)}
    errs = {"gram_chol (bf16 data)": pf["res"]["gram_chol"],
            "cross_solve (bf16 data)": pf["res"]["cross_solve"],
            "oos_contract (bf16 data)": pf["res"]["oos_contract"],
            "gram_chol_dist (bf16 data)": ps["res"]["gram_chol_dist"],
            "cross_solve_dist (bf16 data)": ps["res"]["cross_solve_dist"]}
    units = {
        "gram_chol (bf16 data)": f"one bf16 fit: one grouped launch ({LEVELS}"
                                 " Sigma levels with factors) and one for "
                                 "the leaves' Adiag",
        "cross_solve (bf16 data)": f"one bf16 fit: one grouped launch (U and "
                                   f"{LEVELS - 1} W levels)",
        "oos_contract (bf16 data)": "one 4096-query bucket, both terms in one"
                                    " launch; device time",
        "gram_chol_dist (bf16 data)": f"one bf16 sweep sigma: one grouped "
                                      f"launch ({LEVELS} Sigma levels) and "
                                      "one gram_dist for the Adiag",
        "cross_solve_dist (bf16 data)": f"one bf16 sweep sigma: one grouped "
                                        f"launch (U and {LEVELS - 1} W "
                                        "levels)"}
    counts = {**pf["launches"], **{k: v for k, v in ps["launches"].items()
                                   if "dist" in k}}
    for name, keys, src, tpu in BF16_RECORDS:
        ms, f32_ms, t = turns[name]
        rec = kernel_record(
            name, "src/repro_torch/csrc/" + src, "src/repro/kernels/" + tpu,
            sum(counts[k] for k in keys), errs[name], ms, plain[name],
            bounds[name], unit=units[name], f32_entry_ms=f32_ms,
            turns_ms={"bf16": [t[0], t[3]], "f32": [t[1], t[2]]})
        if name.startswith("oos"):
            rec["launches"] = pf["serve_launches"]["oos_contract_bf16"]
        rows.append(rec)
        say(f"[8d precision] timing {name} ({rec['unit']}): bf16 entry "
            f"{ms:.4f} ms, f32 entry {f32_ms:.4f} ms (in turns: "
            f"{rec['turns_ms']}), plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, bf16 data at 2 "
            f"bytes), launches {rec['launches']}")
    return rows


def phase_precision(fit, sw, dev) -> list[dict]:
    """Phase 8d: the mixed-precision policy (SolveConfig.precision) on the
    card, (a)-(f) above; returns the kernels' records of the bf16-data
    entries."""
    t = time.perf_counter()
    times = {}
    bf16_kernel_shapes(dev)
    times["kernels"] = time.perf_counter() - t
    precision_bounds(dev)
    times["a"] = time.perf_counter() - t - sum(times.values())
    pf = precision_fit(fit, dev)
    times["b"] = time.perf_counter() - t - sum(times.values())
    ps = precision_sweep(sw, dev)
    times["c"] = time.perf_counter() - t - sum(times.values())
    served = precision_serving(pf, fit)
    pf["serve_launches"] = served["launches"]
    times["d"] = time.perf_counter() - t - sum(times.values())
    precision_floor(dev)
    times["e"] = time.perf_counter() - t - sum(times.values())
    precision_launcher(dev)
    times["f"] = time.perf_counter() - t - sum(times.values())
    rows = bf16_timing(pf, ps)
    times["timing"] = time.perf_counter() - t - sum(times.values())
    say(f"[8d precision] phase done in {time.perf_counter() - t:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in times.items()) + ")")
    return rows


# ---------------------------------------------------------------------------
# Phase 8e: the tuning and launch surface -- the autotune tile database, the
# roofline, the corrupt-database fault, a measured block steering B7, and
# the quickstart
# ---------------------------------------------------------------------------

# The reference's default sweep shape (autotune_all) and the covtype fit's
# shapes, its oos stages at the serving request size (their record steers
# B7 on that path).
SERVE_Q = 4096
TUNE_SHAPES = {"default": dict(n0=256, r=16, k=2, d=4),
               "covtype": dict(n0=LEAF, r=RANK, k=N_CLASSES, d=D,
                               queries=SERVE_Q)}
# Stages whose kernels factor a whole tile: past m 235 (B1), 240 (B3, B8)
# they take the panel form, which the default shape's n0 256 reaches.
PANEL_STAGES = ("leaf_factor", "build_gram", "build_gram_dist")


def tune_records_text(recs, hw_nominal, hw_cal) -> list[str]:
    """One line a record: winner, best time, achieved rates, and the
    stage's roofline fraction against the nominal and calibrated H100
    models."""
    from repro_torch.utils import roofline

    out = []
    for rec in recs:
        b = rec["bucket"]
        qb = (1 if rec["stage"] in ("kernel_matvec", "pairwise_kernel")
              else b["batch"])
        shape = dict(batch=qb, n0=b["n0"], r=b["r"], k=b["k"], d=b["d"])
        nom = roofline.stage_roofline(rec["stage"], rec["best_s"],
                                      hw=hw_nominal, **shape)
        cal = roofline.stage_roofline(rec["stage"], rec["best_s"], hw=hw_cal,
                                      **shape)
        out.append(
            f"{rec['stage']} [{rec['backend']}, block {rec['block']}, cuda "
            f"block {rec['cuda_block']}] {rec['best_s'] * 1e6:.1f} us, "
            f"{rec['rates']['flops_per_s'] / 1e9:.2f} GFLOP/s, "
            f"{rec['rates']['bytes_per_s'] / 1e9:.2f} GB/s; roofline "
            f"{nom['achieved_frac']:.2e} nominal ({nom['bound']}), "
            f"{cal['achieved_frac']:.2e} calibrated")
    return out


def tune_b11_check(shape) -> float:
    """B11 on the autotune sweep's own pairwise_kernel inputs at ``shape``
    (autotune.sweep_inputs, the sweep's seed): one launch on the "tc"
    route, within 1e-5 absolute of the plain version.  After the counted
    sweep, so its launch counts no path.  Returns max|d|."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.kernel_tile import ops
    from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref
    from repro_torch.kernels.registry import get_impl

    args, kw = autotune.sweep_inputs(
        "pairwise_kernel", **{k: v for k, v in shape.items()
                              if k != "queries"})
    before = ops.pairwise_kernel.tc_launches
    got = get_impl("pairwise_kernel", "cuda")(*args, **kw)
    err = float((got - pairwise_kernel_ref(*args, **kw)).abs().max())
    sync()
    require(ops.pairwise_kernel.tc_launches == before + 1,
            f"pairwise_kernel on the sweep's inputs {tuple(args[0].shape)} "
            f"x {tuple(args[1].shape)}: one tc launch")
    require(bool(torch.isfinite(got).all()) and err <= 1e-5,
            f"pairwise_kernel on the sweep's inputs: max|d| {err:.3e} <= "
            "1e-5")
    return err


def tune_sweeps() -> dict:
    """Phase 8e (a): ``autotune_all`` at each of TUNE_SHAPES on the card,
    the counts set to 0 around each call: every "cuda" candidate runs (the
    default shape's PANEL_STAGES, at n0 256, on their panel forms, each
    counted), B11 launches through the ``pairwise_kernel`` stage, and a
    second call is a cache hit that launches nothing.  Then B11's output
    on the sweep's inputs against the plain version (tune_b11_check)."""
    from repro_torch.kernels import autotune

    out = {"records": {}, "b11_launches": 0, "b11_err": 0.0}
    for tag, shape in TUNE_SHAPES.items():
        recs, launches, _ = counted(lambda: autotune.autotune_all(**shape))
        require(not any(r["cached"] for r in recs), f"{tag}: a fresh sweep")
        for rec in recs:
            errs = [c for c in rec["candidates"]
                    if c["backend"] == "cuda" and "error" in c]
            require(not errs and any(
                c["backend"] == "cuda" and "s" in c
                for c in rec["candidates"]),
                f"autotune {tag} {rec['stage']}: every cuda candidate ran: "
                f"{errs}")
        panel = {k: launches[f"{k}_panel"] for k in
                 ("leaf_factor", "gram_chol", "gram_chol_dist")}
        require(tag != "default" or all(panel.values()),
                f"autotune {tag}: {PANEL_STAGES} at n0 256 launched their "
                f"panel forms: {panel}")
        require(launches["kernel_tile"] > 0
                and launches["kernel_tile_tc"] == launches["kernel_tile"],
                f"autotune {tag}: B11 launched through the pairwise_kernel "
                f"stage, on its tensor-core route: {launches['kernel_tile']}"
                f" ({launches['kernel_tile_tc']} tc)")
        out["b11_launches"] += launches["kernel_tile"]
        hit, l2, p2 = counted(lambda: autotune.autotune_all(**shape))
        require(all(r["cached"] for r in hit) and not any(l2.values())
                and not any(p2.values()),
                f"autotune {tag}: the second call is a cache hit that "
                f"launches nothing: {l2}, {p2}")
        out["records"][tag] = recs
        err = tune_b11_check(shape)
        out["b11_err"] = max(out["b11_err"], err)
        launched = {k: v for k, v in launches.items() if v}
        say(f"[8e tuning] (a) autotune_all {tag} {shape}: {len(recs)} "
            f"records, launches {launched} (B11 {launches['kernel_tile']}, "
            f"all tc); panel forms {panel}; a "
            f"second call: {len(hit)} cache hits, no launch; B11 on the "
            f"sweep's pairwise_kernel inputs max|d| {err:.2e} <= 1e-5 of "
            f"the plain version ok")
    return out


def tune_consult_cost(fit) -> dict:
    """Phase 8e (e): what B7's tile-database consult costs serving.  The
    covtype serving bucket's record holds the cold plan's rows, so both
    arms launch the same plan; 4,096-query requests through phase 3's
    engine, host clock around each (the consult is host work), 50 a turn,
    in turns twice over (consult on, REPRO_AUTOTUNE=0, REPRO_AUTOTUNE=0,
    on); and the consult alone (oos_stage.ops.measured_block), warm,
    20,000 calls a turn in the same order.  Each turn's median, in
    microseconds; an arm's figure is the median of its four turns."""
    import os
    import statistics

    from repro_torch.kernels import autotune
    from repro_torch.kernels.oos_stage import ops as oops

    eng, q = fit["model"].engine, fit["xt"][:SERVE_Q]
    ms, cold = (LEAF, RANK), oops.plan((LEAF, RANK), D, N_CLASSES, 4)
    db = autotune.get_db()
    key = autotune.bucket_key("oos_local", autotune.device_kind(),
                              "float32", n0=LEAF, r=0, k=N_CLASSES, d=D)
    db.put(key, {**db.get(key), "cuda_block": cold["rows"]})
    require(oops.measured_block(ms, D, N_CLASSES, 4) == cold["rows"],
            "(e) the warm database holds the cold plan's rows")

    def arm(on):
        if on:
            os.environ.pop("REPRO_AUTOTUNE", None)
        else:
            os.environ["REPRO_AUTOTUNE"] = "0"
        ts = []
        for _ in range(50):
            sync()
            t0 = time.perf_counter()
            eng(q)
            sync()
            ts.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(ts)

    def consult(on, reps=20000):
        if on:
            os.environ.pop("REPRO_AUTOTUNE", None)
        else:
            os.environ["REPRO_AUTOTUNE"] = "0"
        t0 = time.perf_counter()
        for _ in range(reps):
            oops.measured_block(ms, D, N_CLASSES, 4)
        return (time.perf_counter() - t0) / reps * 1e6

    order = (True, False, False, True) * 2
    try:
        eng(q)
        turns = [arm(on) for on in order]
        alone = [consult(on) for on in order]
    finally:
        os.environ.pop("REPRO_AUTOTUNE", None)

    def arm_of(ts, on):
        return statistics.median(t for t, o in zip(ts, order) if o == on)

    out = {"request_us_on": arm_of(turns, True),
           "request_us_off": arm_of(turns, False), "turns_us": turns,
           "consult_us_on": arm_of(alone, True),
           "consult_us_off": arm_of(alone, False), "consult_turns_us": alone}
    say(f"[8e tuning] (e) B7's consult on serving, a warm database holding "
        f"the cold plan ({cold['rows']} rows): {SERVE_Q}-query requests in "
        f"turns (on, off, off, on) x 2, host clock, each a median of 50: "
        f"{', '.join(f'{t:.1f}' for t in turns)} us (on "
        f"{out['request_us_on']:.1f}, off {out['request_us_off']:.1f}, "
        f"difference {out['request_us_on'] - out['request_us_off']:+.1f} "
        f"us); the consult alone, same turns: "
        f"{', '.join(f'{t:.3f}' for t in alone)} us a launch (on "
        f"{out['consult_us_on']:.3f}, REPRO_AUTOTUNE=0 "
        f"{out['consult_us_off']:.3f})")
    return out


def tune_steer_and_corrupt(fit, db_file) -> dict:
    """Phase 8e (b), (c): on phase 3's model at covtype width, 4,096 test
    queries through its engine.  (c) a measured leaf_block (the sweep's
    covtype oos_local record, its cuda block, or the fastest other cuda
    candidate where that is the cold plan's) steers B7: its plan's rows
    change and the predictions stay within 1e-4 of the cold run's; (b) the
    corrupt database is detected, the serving bucket's plan is the cold
    one and the predictions are bit for bit the cold run's, and the next
    save repairs the file."""
    import os

    from repro_torch.kernels import autotune
    from repro_torch.kernels.oos_stage import ops as oops
    from repro_torch.testing import faultinject as fi

    eng, q = fit["model"].engine, fit["xt"][:4096]
    ms = (LEAF, RANK)
    cold = oops.plan(ms, D, N_CLASSES, 4)
    os.environ["REPRO_AUTOTUNE"] = "0"
    try:
        z_cold = eng(q)
    finally:
        del os.environ["REPRO_AUTOTUNE"]
    sync()

    db = autotune.get_db()
    key = autotune.bucket_key("oos_local", autotune.device_kind(),
                              "float32", n0=LEAF, r=0, k=N_CLASSES, d=D)
    rec = db.get(key)
    require(rec is not None, f"the covtype serving bucket's record {key}")
    timed = sorted((c for c in rec["candidates"]
                    if c["backend"] == "cuda" and "s" in c),
                   key=lambda c: c["s"])
    block = (rec["cuda_block"] if rec["cuda_block"] != cold["rows"] else
             next(c["block"] for c in timed if c["block"] != cold["rows"]))
    db.put(key, {**rec, "cuda_block": block})
    db.save()
    autotune.reset_db()
    seen, plan0 = [], oops.plan

    def recording(*a, **kw):
        p = plan0(*a, **kw)
        seen.append(p["rows"])
        return p

    oops.plan = recording
    try:
        z_steer = eng(q)
        sync()
    finally:
        oops.plan = plan0
    gap = rel_max(z_steer, z_cold)
    require(seen and set(seen) == {block} and block != cold["rows"],
            f"(c) the measured block {block} steers B7's plan (rows "
            f"{sorted(set(seen))}, cold {cold['rows']})")
    require(gap <= 1e-4, f"(c) steered predictions within 1e-4 of the cold "
            f"run's: {gap:.3e}")
    say(f"[8e tuning] (c) measured leaf_block {block} (sweep's cuda block "
        f"{rec['cuda_block']}, cold plan {cold['rows']} rows) steers B7: "
        f"{len(seen)} launches with {block} rows; predictions on 4096 "
        f"queries rel {gap:.3e} <= 1e-4 of the cold run ok")

    good = dict(autotune.get_db().entries)
    fi.corrupt_tile_db(db_file)
    bad = autotune.get_db()
    measured = oops.measured_block(ms, D, N_CLASSES, 4)
    z_bad = eng(q)
    sync()
    require(bad.corrupt and not bad.entries, "(b) the corruption is detected")
    require(measured is None and oops.plan(ms, D, N_CLASSES, 4, measured)
            == cold, "(b) the serving bucket's plan is the cold plan")
    require(torch.equal(z_bad, z_cold), "(b) predictions on the corrupt "
            "database bit for bit the cold run's")
    for k, v in good.items():
        bad.put(k, v)
    bad.save()
    autotune.reset_db()
    healed = autotune.get_db()
    require(not healed.corrupt and len(healed.entries) == len(good),
            "(b) the next save repairs the file")
    say(f"[8e tuning] (b) corrupt_tile_db: detected (corrupt, no entries), "
        f"the serving bucket's plan = the cold plan ({cold['rows']} rows, "
        f"{cold['warps']} warps), predictions bit for bit the cold run's; "
        f"the next save rewrote {len(healed.entries)} entries ok")
    return {"steered_rows": block, "cold_rows": cold["rows"],
            "steer_gap": gap}


def tune_quickstart() -> dict:
    """Phase 8e (d): ``repro_torch.examples.quickstart`` on the card."""
    from repro_torch.examples import quickstart

    t = time.perf_counter()
    out = quickstart.main([])
    sync()
    vals = [v for k, v in out.items() if k != "gp_var"] + out["gp_var"]
    require(all(math.isfinite(v) for v in vals)
            and all(v > 0 for v in out["gp_var"]),
            f"quickstart: finite errors and positive variances: {out}")
    say(f"[8e tuning] (d) quickstart on the card in "
        f"{time.perf_counter() - t:.2f} s: " + ", ".join(
            f"{k} {v:.4f}" for k, v in out.items() if k != "gp_var"))
    return out


def phase_tuning(fit, db_file) -> dict:
    """Phase 8e: (a)-(d) above, on the run's own tile database (a
    temporary file from the start of the run), which it empties when done
    so that the later phases run the cold plans."""
    import os

    from repro_torch.kernels import autotune
    from repro_torch.kernels.oos_stage import ops as oops
    from repro_torch.utils import roofline

    t = time.perf_counter()
    out = tune_sweeps()
    hw_nom = roofline.hw_model("gpu", calibrate=False)
    hw_cal = roofline.hw_model("gpu")
    require(hw_cal["calibration"] == "measured (tile_db)",
            "the H100 model calibrates from the sweeps")
    say(f"[8e tuning] H100 model nominal {hw_nom['peak_flops']:.3e} FLOP/s, "
        f"{hw_nom['hbm_bw']:.3e} B/s; calibrated from the database "
        f"{hw_cal['peak_flops']:.3e} FLOP/s, {hw_cal['hbm_bw']:.3e} B/s")
    for tag, recs in out["records"].items():
        for line in tune_records_text(recs, hw_nom, hw_cal):
            say(f"[8e tuning] (a) {tag} {line}")
        winners = [r["stage"] for r in autotune.torch_winners(recs)]
        say(f"[8e tuning] (a) {tag}: buckets the plain version won (a "
            f"finding; the route stays the kernel's): {winners}")
    for tag in ("default", "covtype"):
        cold = oops.plan((TUNE_SHAPES[tag]["n0"], TUNE_SHAPES[tag]["r"]),
                         TUNE_SHAPES[tag]["d"], TUNE_SHAPES[tag]["k"], 4)
        blocks = {r["stage"]: r["cuda_block"] for r in out["records"][tag]
                  if r["stage"] in autotune.OOS_STAGES}
        say(f"[8e tuning] (a) {tag}: the oos stages' measured blocks "
            f"against the cold plan's {cold['rows']} rows: " + ", ".join(
                f"{st} {b} ({'the same' if b == cold['rows'] else 'differs'})"
                for st, b in blocks.items())
            + f"; B7's consult reads oos_local's record first, so it steers "
            f"this bucket to {blocks['oos_local']} rows")
    out.update(tune_steer_and_corrupt(fit, db_file))
    out["consult"] = tune_consult_cost(fit)
    out["quickstart"] = tune_quickstart()
    os.remove(db_file)
    autotune.reset_db()
    out["seconds"] = time.perf_counter() - t
    say(f"[8e tuning] phase done in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# LM serving: Zamba2-7B through ServeSession, B14 and B15
# ---------------------------------------------------------------------------

def attention_cost(q, k, causal=True):
    """flash_attention: q, k, v read once, o written once; QK^T and PV over
    the causal lower triangle (S(S + 1)/2 pairs, 2D flops each per
    product) or the whole square."""
    b, hq, s, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes, 4 * b * hq * pairs * d


def ssd_cost(c, xdt):
    """ssd_intra_chunk: c, b, xdt and cs read once, y written once; C B^T
    and (S L) X over the Q(Q + 1)/2 causal pairs of each chunk (2N and 2P
    flops) and the decay on each pair (exp and a multiply)."""
    bh, nc, q, n = c.shape
    p = xdt.shape[3]
    pairs = bh * nc * q * (q + 1) // 2
    nbytes = 4 * (2 * c.numel() + 2 * xdt.numel() + bh * nc * q)
    return nbytes, pairs * (2 * n + 2 * p + 2)


@contextlib.contextmanager
def plain_lm_stages():
    """Route the LM path's ``attention`` and ``ssd_intra_chunk`` stages
    through their plain versions on the card: the plain route of the
    end-to-end comparison (a forced "torch" backend refuses CUDA tensors by
    design)."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

    plain = {"attention": lambda q, k, v, *, causal=True, window=0:
             attention_ref(q, k, v, causal=causal, window=window),
             "ssd_intra_chunk": ssd_intra_chunk_ref}
    saved = {stage: registry.get_impl(stage, "cuda") for stage in plain}
    for stage, fn in plain.items():
        registry.register(stage, "cuda")(fn)
    try:
        yield
    finally:
        for stage, fn in saved.items():
            registry.register(stage, "cuda")(fn)


def check_b14(shape, dtype, causal, gen, misalign=False):
    """B14 against its plain version on one set of random inputs: q, k, v
    ~ N(0, 1) of (B, Hq, Hkv, S, D) ``shape`` (with ``misalign``, views one
    element into their buffers, so neither TMA nor 16-byte copies can read
    them).  The kernel that ran must be the one the shape calls for: float32
    the CUDA-core kernel; bfloat16 the wgmma kernel where D % 8 == 0 and
    the views are aligned, else the mma.sync kernel.  bf16 gates each
    output within B14_BF16_REL of its value plus B14_BF16_FLOOR of the
    largest; f32 within B14_F32_RTOL of the largest.  Returns max
    |o - o_plain|."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, hq, hkv, s, d = shape
    dev = gen.device
    q, k, v = (torch.randn(math.prod(sh) + 1, generator=gen, device=dev)
               .to(dtype)[int(misalign):][:math.prod(sh)].view(sh)
               for sh in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = flash_attention.launches, flash_attention.wgmma_launches
    got = flash_attention(q, k, v, causal=causal)
    total = flash_attention.launches - before[0]
    wgmma = flash_attention.wgmma_launches - before[1]
    want = attention_ref(q, k, v, causal=causal)
    sync()
    ran = "wgmma" if wgmma else "f32" if dtype == torch.float32 else "mma"
    expect = ("f32" if dtype == torch.float32 else "wgmma"
              if d % 8 == 0 and not misalign else "mma")
    name = (f"flash_attention {tuple(q.shape)}/{hkv} {dtype} causal={causal}"
            f"{' misaligned' if misalign else ''} [{ran} kernel]")
    require(total == 1 and ran == expect,
            f"{name}: one launch of the {expect} kernel ({total} launches, "
            f"{wgmma} wgmma)")
    require(bool(torch.isfinite(got).all()), f"{name} output finite")
    diff = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        limit = B14_BF16_REL * want.float().abs() + B14_BF16_FLOOR * top
        worst = float((diff / limit).max())
        require(worst <= 1.0, f"{name}: worst |diff| / limit {worst:.3f} "
                f"<= 1")
        say(f"[2b lm] {name}: max |diff| {float(diff.max()):.3e} (largest "
            f"output {top:.3f}), worst diff / limit {worst:.3f}; "
            f"{int((diff > 0).sum())} of {diff.numel()} outputs differ")
    else:
        rel = float(diff.max()) / top
        require(rel <= B14_F32_RTOL, f"{name} rel {rel:.3e} <= "
                f"{B14_F32_RTOL}")
        say(f"[2b lm] {name}: rel {rel:.3e}")
    return float(diff.max())


def ssd_inputs(shape, gen):
    """Random B15 inputs of (BH, nc, Q, N, P) ``shape``: c, b ~ N(0, 1),
    xdt ~ N(0, 1), cs the within-chunk cumulative sum of steps -U(0, 1.5)
    (dt A of the model: softplus'd dt times -exp(a_log))."""
    bh, nc, q, n, p = shape
    dev = gen.device
    c, b = (torch.randn((bh, nc, q, n), generator=gen, device=dev)
            for _ in range(2))
    xdt = torch.randn((bh, nc, q, p), generator=gen, device=dev)
    cs = torch.cumsum(-1.5 * torch.rand((bh, nc, q), generator=gen,
                                        device=dev), dim=-1)
    return c, b, xdt, cs


def check_b15(args, misalign=False):
    """B15 against its plain version: max |y - y_plain| <= B15_RTOL times
    the largest componentwise magnitude (|C||B|^T * L)|X|.  The kernel that
    ran must be the one ``ops.variant`` names for the widths and addresses:
    the wgmma kernel where N and P are multiples of 4 up to 64 and c, b,
    xdt 16-byte aligned, else the mma.sync kernel (with ``misalign``, c, b
    and xdt are views one element into their buffers).  Returns
    max |y - y_plain|."""
    from repro_torch.kernels.ssd_chunk import ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

    if misalign:
        args = tuple(torch.cat([t.new_zeros(1), t.flatten()])[1:]
                     .view(t.shape) if t.ndim == 4 else t for t in args)
    c, b, xdt, cs = args
    before = ops.ssd_intra_chunk.launches, ops.ssd_intra_chunk.wgmma_launches
    got = ops.ssd_intra_chunk(*args)
    total = ops.ssd_intra_chunk.launches - before[0]
    wgmma = ops.ssd_intra_chunk.wgmma_launches - before[1]
    want = ssd_intra_chunk_ref(*args)
    mag = float(ssd_intra_chunk_ref(c.abs(), b.abs(), xdt.abs(), cs).max())
    sync()
    ran = "wgmma" if wgmma else "mma"
    expect = ops.variant(c.shape[3], xdt.shape[3], c.data_ptr(),
                         b.data_ptr(), xdt.data_ptr())
    name = (f"ssd_intra_chunk {tuple(c.shape)} P={xdt.shape[3]}"
            f"{' misaligned' if misalign else ''} [{ran} kernel]")
    require(total == 1 and ran == expect, f"{name}: one launch of the "
            f"{expect} kernel ({total} launches, {wgmma} wgmma)")
    require(bool(torch.isfinite(got).all()), f"{name} output finite")
    err = float((got - want).abs().max())
    require(err <= B15_RTOL * mag, f"{name}: {err:.3e} <= {B15_RTOL} x "
            f"{mag:.3e}")
    say(f"[2b lm] {name}: max |diff| {err:.3e} = {err / mag:.3e} of the "
        f"magnitude {mag:.3e}")
    return err


def lm_kernel_checks(cfg, dev) -> dict:
    """B14 and B15 against their plain versions at the prefill's shapes
    and at small ones."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    b, s = LM_REQUESTS[0][:2]
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    b14 = check_b14((b, h, kv, s, hd), torch.bfloat16, True, gen)
    for shape, causal in (((2, 4, 2, 200, 16), True),
                          ((2, 4, 2, 200, 112), True),
                          ((2, 4, 2, 200, 112), False),
                          ((1, 4, 4, 256, 16), False),
                          ((1, 2, 1, 130, 72), True)):
        for dtype in (torch.float32, torch.bfloat16):
            check_b14(shape, dtype, causal, gen)
    check_b14((1, 2, 1, 130, 72), torch.bfloat16, True, gen, misalign=True)
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    full = (b * nh, s // cfg.ssm_chunk, cfg.ssm_chunk, cfg.ssm_state,
            cfg.ssm_head_dim)
    b15 = check_b15(ssd_inputs(full, gen))
    # Q, N and P not multiples of 8: (3, 2, 99, 61, 43) takes the mma.sync
    # kernel with 4-byte copies, (2, 3, 130, 60, 44) the wgmma kernel; N =
    # P = 128 and a misaligned view the mma.sync kernel
    for shape in ((6, 3, 100, 16, 24), (2, 2, 256, 128, 128),
                  (3, 2, 99, 61, 43), (2, 3, 130, 60, 44)):
        check_b15(ssd_inputs(shape, gen))
    check_b15(ssd_inputs((2, 2, 256, 64, 64), gen), misalign=True)
    return {"b14_err": b14, "b15_err": b15}


def lm_request(cfg, params, toks, new, profile=False) -> dict:
    """One request through ``ServeSession``: the prefill and the greedy
    decode, each with its launch counts and wall time; with ``profile``,
    then four more decode steps under the profiler."""
    from repro_torch.serving.serve_loop import ServeSession

    b, s = toks.shape
    sess = ServeSession(cfg, params, max_seq=s + new + (16 if profile else 0))
    sync()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    last, pre_launches, plain = counted(
        lambda: sess.prefill({"tokens": toks}))
    t_prefill = time.perf_counter() - t
    require_launches(f"prefill {b} x {s}", pre_launches, plain, LM_LAUNCHES)
    require(tuple(last.shape) == (b, cfg.vocab)
            and bool(torch.isfinite(last).all()),
            f"prefill {b} x {s}: finite logits of shape (B, V)")
    peak_prefill = torch.cuda.max_memory_allocated() / 2 ** 30
    first = torch.argmax(last, dim=-1)[:, None]
    t = time.perf_counter()
    out, launches, plain = counted(lambda: sess.decode(first, steps=new))
    t_decode = time.perf_counter() - t
    require_launches(f"decode {b} x {new}", launches, plain, {})
    require(tuple(out.shape) == (b, new + 1)
            and bool(((out >= 0) & (out < cfg.vocab)).all()),
            f"decode {b} x {new}: {new} tokens in the vocabulary")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"[2b lm] request {b} x {s} + {new}: prefill {t_prefill:.3f} s "
        f"({b * s / t_prefill:,.0f} tokens/s), launches "
        f"{ {k: v for k, v in pre_launches.items() if v} }; decode "
        f"{t_decode / new * 1e3:.2f} ms/token ({b * new / t_decode:.1f} "
        f"tokens/s), launches {sum(launches.values())}; peak memory "
        f"{peak_prefill:.2f} GiB at prefill, "
        f"{peak:.2f} GiB in all")
    say(f"[2b lm]   first row's tokens: {out[0, :12].tolist()}")
    if profile:
        profile_device(f"one {LM_ARCH} decode step (batch {b}, position "
                       f"{sess.pos})", lambda: sess.decode(
                           out[:, -1:], steps=1), 4, 10)
    return {"last": last, "tokens": out, "prefill_s": t_prefill,
            "decode_ms": t_decode / new * 1e3, "launches": pre_launches}


def route_gap(cfg, params, toks, last, what, gate) -> float:
    """The prefill's last-token logits through the plain stages on the
    card against the kernel route's ``last``; with ``gate``, within
    LM_LOGIT_RTOL of the largest logit and the same greedy token wherever
    the plain top-2 margin exceeds twice that.  Returns the relative gap."""
    from repro_torch.serving.serve_loop import ServeSession

    b, s = toks.shape
    sess = ServeSession(cfg, params, max_seq=s + 1)
    with plain_lm_stages():
        plain_last, launches, plain = counted(
            lambda: sess.prefill({"tokens": toks}))
    want_calls = (LM_LAUNCHES["flash_attention"],
                  LM_LAUNCHES["ssd_intra_chunk"])
    require(not any(launches.values())
            and (plain["attention_ref"], plain["ssd_intra_chunk_ref"])
            == want_calls, f"the plain route ran the plain stages only: "
            f"{launches} {plain}")
    del sess
    got, want = last.float(), plain_last.float()
    require(bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all()), f"{what} logits finite")
    top = float(want.abs().max())
    gap = float((got - want).abs().max()) / top
    top2 = torch.topk(want, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * LM_LOGIT_RTOL * top
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    say(f"[2b lm] kernel vs plain route, {what}, last-token logits {b} x "
        f"{s}: max |diff| {gap:.3e} of the largest logit {top:.3f}"
        f"{' (gated)' if gate else ' (printed, not gated)'}; greedy tokens "
        f"agree in {int(same.sum())} of {b} rows ({int(decided.sum())} "
        f"decided by a margin > {2 * LM_LOGIT_RTOL:.0e} x largest)")
    if gate:
        require(gap <= LM_LOGIT_RTOL, f"{what} route gap {gap:.3e} <= "
                f"{LM_LOGIT_RTOL}")
        require(bool(same[decided].all()),
                f"{what}: greedy tokens agree where decided")
    return gap


def route_gap_f32(cfg, params, toks) -> float:
    """The gated comparison: both routes in float32 on the same weights,
    upcast from ``params`` (the bf16 copy is released by the caller)."""
    import dataclasses

    from repro_torch.serving.serve_loop import ServeSession

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: {n: t.float() for n, t in v.items()} for k, v in params.items()}
    b, s = toks.shape
    sess = ServeSession(cfg32, p32, max_seq=s + 1)
    last, launches, plain = counted(lambda: sess.prefill({"tokens": toks}))
    require_launches(f"float32 prefill {b} x {s}", launches, plain,
                     LM_LAUNCHES_F32)
    del sess
    return route_gap(cfg32, p32, toks, last, "float32", gate=True)


def lm_timing(cfg, checks, launches, prefill, dev) -> list[dict]:
    """B14 and B15 at the 4 x 3,840 prefill's shapes: kernel, plain and
    library times beside their bounds (random inputs of those shapes);
    ``launches`` are that prefill's counts, ``prefill`` its first-call wall
    time, tokens/s and profiled device time (B15's record carries them).
    B15's bound is its tensor-core route's (its bytes, or three TF32 passes
    at PEAK_TF32), beside the f32 CUDA-core bound of its first design."""
    from torch.nn import functional as F

    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         launch_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    b, s = LM_REQUESTS[0][:2]
    shape = (b, cfg.n_heads, s, cfg.head_dim)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    # the wgmma kernel (through the wrapper, as the prefill runs it) and
    # the mma.sync kernel it replaced, on the same inputs, in turns
    out = torch.empty_like(q)
    turns = [time_ms(fn, 10) for fn in (
        lambda: flash_attention(q, k, v),
        lambda: launch_kernel("mma", q, k, v, out),
        lambda: launch_kernel("mma", q, k, v, out),
        lambda: flash_attention(q, k, v))]
    rec14 = kernel_record(
        "flash_attention", src + "flash_attention.cu",
        tpu + "flash_attention/flash_attention.py:77",
        launches["flash_attention"], checks["b14_err"],
        (turns[0] + turns[3]) / 2,
        time_ms(lambda: attention_ref(q, k, v), 2, warmup=1),
        bound_ms(*attention_cost(q, k), peak_flops=PEAK_BF16),
        library=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 5),
        unit=f"one launch: {tuple(q.shape)} bf16, causal",
        library_call="F.scaled_dot_product_attention(is_causal=True)",
        kernel="wgmma (TMA, warp-specialised)",
        wgmma_launches=launches["flash_attention_wgmma"],
        previous_ms=(turns[1] + turns[2]) / 2,
        previous="mma.sync (flash_attention_bf16)",
        turns_ms={"wgmma": [turns[0], turns[3]],
                  "mma.sync": [turns[1], turns[2]]})
    del q, k, v, out
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    args = ssd_inputs((b * nh, s // cfg.ssm_chunk, cfg.ssm_chunk,
                       cfg.ssm_state, cfg.ssm_head_dim), gen)
    c, bm, xdt, cs = args
    qlen = cfg.ssm_chunk
    mask = torch.ones((qlen, qlen), dtype=torch.bool, device=dev).tril()

    def chain():
        sc = torch.matmul(c, bm.mT)
        decay = torch.exp(cs[..., :, None] - cs[..., None, :])
        return torch.matmul(sc * decay.masked_fill_(~mask, 0.0), xdt)

    nbytes, flops = ssd_cost(c, xdt)
    # the wgmma kernel (through the wrapper, as the prefill runs it) and the
    # mma.sync kernel, on the same inputs, in turns
    y15 = torch.empty_like(xdt)
    turns15 = [time_ms(fn, 10) for fn in (
        lambda: ssd_ops.ssd_intra_chunk(*args),
        lambda: ssd_ops.launch_kernel("mma", *args, y15),
        lambda: ssd_ops.launch_kernel("mma", *args, y15),
        lambda: ssd_ops.ssd_intra_chunk(*args))]
    rec15 = kernel_record(
        "ssd_intra_chunk", src + "ssd_chunk.cu",
        tpu + "ssd_chunk/ssd_chunk.py:43", launches["ssd_intra_chunk"],
        checks["b15_err"], (turns15[0] + turns15[3]) / 2,
        time_ms(lambda: ssd_intra_chunk_ref(*args), 3),
        bound_ms(nbytes, 3 * flops, peak_flops=PEAK_TF32),
        unit=f"one launch: {tuple(c.shape)} P={xdt.shape[3]} f32",
        kernel="split TF32: wgmma (TMA, warp-specialised)",
        wgmma_launches=launches["ssd_intra_chunk_wgmma"],
        previous_ms=(turns15[1] + turns15[2]) / 2,
        previous="split TF32: mma.sync (ssd_intra_chunk_f32)",
        turns_ms={"wgmma": [turns15[0], turns15[3]],
                  "mma.sync": [turns15[1], turns15[2]]},
        bound_f32_ms=bound_ms(nbytes, flops)[0],
        library_chain_ms=time_ms(chain, 5),
        library_chain="torch.matmul + exp + masked_fill + torch.matmul",
        **prefill)
    say(f"[9 timing] flash_attention in turns (wgmma, mma.sync, mma.sync, "
        f"wgmma): {', '.join(f'{t:.4f}' for t in turns)} ms; wgmma "
        f"{rec14['ms']:.4f} ms against mma.sync {rec14['previous_ms']:.4f} "
        f"ms ({rec14['previous_ms'] / rec14['ms']:.2f}x); launches per "
        f"prefill: wgmma {rec14['wgmma_launches']} of "
        f"{rec14['launches']}")
    for rec in (rec14, rec15):
        extra = ""
        if "library_chain_ms" in rec:
            extra = (f", chain {rec['library_chain']} "
                     f"{rec['library_chain_ms']:.4f} ms")
        say(f"[9 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']} ms{extra}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), launches {rec['launches']} per prefill")
    dev_ms = rec15["prefill_device_ms"]
    say(f"[9 timing] ssd_intra_chunk in turns (wgmma, mma.sync, mma.sync, "
        f"wgmma): {', '.join(f'{t:.4f}' for t in turns15)} ms; wgmma "
        f"{rec15['ms']:.4f} ms against mma.sync {rec15['previous_ms']:.4f} "
        f"ms ({rec15['previous_ms'] / rec15['ms']:.2f}x); launches per "
        f"prefill: wgmma {rec15['wgmma_launches']} of {rec15['launches']}")
    say(f"[9 timing] ssd_intra_chunk on the tensor cores: bound of its "
        f"route {rec15['bound_ms']:.4f} ms ({rec15['bound_by']}), of f32 "
        f"CUDA cores {rec15['bound_f32_ms']:.4f} ms; the 4 x 3,840 prefill "
        f"{rec15['prefill_s']:.3f} s on its first call "
        f"({rec15['prefill_tokens_per_s']:,.0f} tokens/s), device time "
        + (f"{dev_ms:.1f} ms" if dev_ms is not None else "not measured"))
    return [rec14, rec15]


def phase_lm(dev) -> list[dict]:
    """Phase 2b: Zamba2-7B serving at full width in bf16 (random weights
    from SEED): B14 and B15 against their plain versions, the two requests
    through ``ServeSession`` with the launch counts read around each
    prefill and each decode, the kernel route against the plain route,
    one prefill profiled, and B14 and B15 timed.  Returns their kernel
    records; frees the model."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    t0 = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    count = sum(math.prod(pd.shape) for _, pd in tf._walk(tf.param_defs(cfg)))
    checks = lm_kernel_checks(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = time.perf_counter()
    params = tf.init_params(cfg, gen)
    sync()
    say(f"[2b lm] {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, SSM state {cfg.ssm_state}, "
        f"vocab {cfg.vocab}; {count:,} parameters in bf16 "
        f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB), drawn in "
        f"{time.perf_counter() - t:.2f} s")
    results = []
    for b, s, new in LM_REQUESTS:
        toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
        results.append(lm_request(cfg, params, toks, new,
                                  profile=not results))
        if len(results) == 1:
            big = toks
    from repro_torch.serving.serve_loop import ServeSession

    b, s = big.shape
    prof = profile_device(f"one {LM_ARCH} prefill ({b} x {s})",
                          lambda: ServeSession(cfg, params,
                                               max_seq=s + 1).prefill(
                              {"tokens": big}), 1, 16)
    prefill = {"prefill_s": results[0]["prefill_s"],
               "prefill_tokens_per_s": b * s / results[0]["prefill_s"],
               "prefill_device_ms": prof and prof["device_ms"]}
    route_gap(cfg, params, big, results[0]["last"], "bf16", gate=False)
    params = {k: {n: t.float() for n, t in v.items()}
              for k, v in params.items()}
    torch.cuda.empty_cache()
    route_gap_f32(cfg, params, big)
    launches = results[0]["launches"]
    del params, results
    torch.cuda.empty_cache()
    records = lm_timing(cfg, checks, launches, prefill, dev)
    torch.cuda.empty_cache()
    say(f"[2b lm] phase done in {time.perf_counter() - t0:.1f} s")
    return records


def kernel_record(name, source, replaces, launches, err, ms, plain, bound,
                  library=None, **extra):
    """One entry of the kernels' JSON line."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library, **extra}


def direct_sum_floor_ms(pairs: int, d: int) -> float:
    """The direct sum's issue floor: an FSUB and an FFMA (or FADD) per
    feature and distinct pair at 132 SMs x 128 lanes x 1.98 GHz (PEAK_F32 /
    2 instructions a second)."""
    return 2 * d * pairs / (PEAK_F32 / 2) * 1e3


def build_timing(args, fl, res) -> list[dict]:
    """Phase 9, fit: B1 and B2 as krr.fit launches them (B1: one grouped
    launch for the 12 Sigma levels with their factors, one launch without
    a factor for the leaves' Adiag; B2: one grouped launch for U and the
    11 W levels), beside the plain versions, the bound of the route (bytes
    or f32 operations for B1; bytes or three TF32 passes for B2, whose f32
    CUDA-core bound is printed beside) and the direct sum's issue floor
    (B1 over each tile's distinct pairs); parts: B1's Sigma levels, its
    largest level and its Adiag; B2's U, its W levels and its largest W
    level.  The per-level designs both replaced, and B1 with the Adiag in
    the Sigma launch, were timed in turns with these launches before they
    were removed (PERF.md section 6)."""
    from repro_torch.kernels.build_stage import ops as bops
    from repro_torch.kernels.build_stage import ref as bref

    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    opts = dict(sigma=SIGMA, jitter=JITTER)
    pts = [p for p, _ in args["gram"]]     # Sigma levels, then the leaves

    def gram_part(ps, want):
        cost = [gram_cost(p, want) for p in ps]
        return {"ms": time_ms(lambda: bops.build_gram_levels(
                    ps, want_chol=want, **opts), 5),
                "plain_ms": time_ms(lambda: bref.build_gram_levels_ref(
                    ps, want_chol=want, **opts), 3),
                "bound_ms": bound_ms(sum(c[0] for c in cost),
                                     sum(c[1] for c in cost))[0]}

    two = time_ms(lambda: (bops.build_gram_levels(pts[:-1], **opts),
                           bops.build_gram(pts[-1], want_chol=False, **opts)),
                  5)
    parts = {"sigma_levels": gram_part(pts[:-1], True),
             "sigma_largest_level": gram_part(pts[-2:-1], True),
             "adiag": gram_part(pts[-1:], False)}
    cost = [gram_cost(p, w) for p, w in args["gram"]]
    records = [kernel_record(
        "gram_chol", src + "build_stage.cu",
        tpu + "build_stage/build_stage.py:124",
        fl["gram_chol"] + fl["gram_chol_levels"], res["gram_chol"], two,
        parts["sigma_levels"]["plain_ms"] + parts["adiag"]["plain_ms"],
        bound_ms(sum(c[0] for c in cost), sum(c[1] for c in cost)),
        unit=f"one fit: one grouped launch ({LEVELS} Sigma levels with "
             "their factors) and one for the leaves' Adiag (no factor)",
        kernel="grouped over the levels, register-tiled direct-sum "
               "distances, B3's blocked factor (chol_blocked.cuh)",
        direct_sum_floor_ms=sum(direct_sum_floor_ms(
            p.shape[0] * p.shape[1] * (p.shape[1] + 1) // 2, p.shape[2])
            for p in pts), **parts)]

    cross = args["cross"]

    def cross_part(c):
        return {"ms": time_ms(lambda: bops.build_cross_levels(
                    *zip(*c), sigma=SIGMA), 5),
                "plain_ms": time_ms(lambda: bref.build_cross_levels_ref(
                    *zip(*c), sigma=SIGMA), 3),
                "bound_ms": cross_tc_bound(
                    sum(cross_cost(*a)[0] for a in c),
                    [a[0].shape[:2] + a[1].shape[1:2] for a in c])[0]}

    total = cross_part(cross)
    records.append(kernel_record(
        "cross_solve", src + "build_stage.cu",
        tpu + "build_stage/build_stage.py:157",
        fl["cross_solve"] + fl["cross_solve_levels"], res["cross_solve"],
        total["ms"], total["plain_ms"],
        cross_tc_bound(sum(cross_cost(*a)[0] for a in cross),
                       [a[0].shape[:2] + a[1].shape[1:2] for a in cross]),
        unit=f"one fit: one grouped launch (U and {len(cross) - 1} W "
             "levels)",
        kernel="grouped over the levels, register-tiled direct-sum "
               "distances, split TF32 on mma.sync (cross_tc.cuh)",
        bound_f32_ms=bound_ms(sum(cross_cost(*a)[0] for a in cross),
                              sum(cross_cost(*a)[1] for a in cross))[0],
        direct_sum_floor_ms=sum(direct_sum_floor_ms(
            a[0].shape[0] * a[0].shape[1] * a[1].shape[1], a[0].shape[2])
            for a in cross),
        u=cross_part(cross[:1]), w_levels=cross_part(cross[1:]),
        w_largest_level=cross_part(cross[-1:])))
    return records


def in_turns(new, old, reps, device=False):
    """Times of ``new`` and ``old`` in turns (new, old, old, new): CUDA
    events around ``reps`` calls, or with ``device`` the card's time alone
    (device_ms).  (new's mean, old's mean, the four.)"""
    t = [device_ms(fn, reps) if device else time_ms(fn, reps)
         for fn in (new, old, old, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def solve_timing(a, fl, res, paths) -> dict:
    """Phase 9, B4 at the fit's shape: the kernel's device time (and events
    around calls), the plain version, the bound (Linv's lower triangle in
    the 32-byte sectors its rows touch) beside the bound that counted all
    of Linv, and B4's launches on every counted path.  The design it
    replaced was timed in turns with it before it was removed (PERF.md
    section 6)."""
    from repro_torch.kernels.hck_leaf import ops as lops
    from repro_torch.kernels.hck_leaf import ref as lref

    return kernel_record(
        "leaf_solve", "src/repro_torch/csrc/leaf_solve.cu",
        "src/repro/kernels/hck_leaf/hck_leaf.py:123", fl["leaf_solve"],
        res["leaf_solve"],
        device_ms(lambda: lops.leaf_solve(*a), 20),
        time_ms(lambda: lref.hck_leaf_solve_ref(*a), 20),
        bound_ms(*solve_cost(*a)), unit="one launch (P 4096, n0 = r = 128, "
        "k 7, f32; device time)",
        call_ms=time_ms(lambda: lops.leaf_solve(*a), 20),
        bound_whole_linv_ms=bound_ms(*solve_cost(*a, whole_linv=True))[0],
        launches_by_path=paths["leaf_solve"])


def matvec_parts(a, b) -> dict:
    """B5 at one launch's shape: the kernel (device time, and events around
    calls), the plain version, the two library calls torch.bmm(adiag, b) +
    torch.bmm(u.mT, b), the bound.  The design it replaced was timed in
    turns with it before it was removed (PERF.md section 6)."""
    from repro_torch.kernels.hck_leaf import ops as lops
    from repro_torch.kernels.hck_leaf import ref as lref

    adiag, u = a
    p, n0, k = b.shape
    r = u.shape[2]
    bound = bound_ms(*matvec_cost(adiag, u, b))
    return {"shape": f"P {p}, n0 {n0}, r {r}, k {k}",
            "ms": device_ms(lambda: lops.leaf_matvec(adiag, u, b), 20),
            "call_ms": time_ms(lambda: lops.leaf_matvec(adiag, u, b), 20),
            "plain_ms": time_ms(lambda: lref.hck_leaf_matvec_ref(adiag, u, b),
                                20),
            "library_ms": device_ms(lambda: (torch.bmm(adiag, b),
                                             torch.bmm(u.mT, b)), 20),
            "bound_ms": bound[0], "bound_by": bound[1]}


def matvec_timing(a, fl, res, paths, shapes) -> dict:
    """Phase 9, B5 at the fit's k (the record's numbers), at k = 1 (a
    Lanczos step's shape) and at k = 12 (the sweep's KPCA block, two tiles
    of 8) by device time, with its launches on every counted
    path, in all and by (n0, r, k)."""
    adiag, u, b = a
    fit_k = matvec_parts((adiag, u), b)
    k1 = matvec_parts((adiag, u), b[..., :1].contiguous())
    k12 = matvec_parts((adiag, u), torch.cat([b, b[..., :5]], dim=2))
    return kernel_record(
        "leaf_matvec", "src/repro_torch/csrc/leaf_matvec.cu",
        "src/repro/kernels/hck_leaf/hck_leaf.py:70", fl["leaf_matvec"],
        max(res["leaf_matvec"], res["leaf_matvec_k1"],
            res["leaf_matvec_k12"]), fit_k["ms"],
        fit_k["plain_ms"], (fit_k["bound_ms"], fit_k["bound_by"]),
        library=fit_k["library_ms"],
        unit=f"one launch at the fit's k ({fit_k['shape']}, f32; device "
             f"time)", library_call="torch.bmm(adiag, b) + torch.bmm(u.mT, b)",
        call_ms=fit_k["call_ms"], fit_k=fit_k, k1=k1, k12=k12,
        launches_by_path=paths["leaf_matvec"],
        launches_by_shape=shapes)


def contract_timing(f, model, fit, sl, res) -> dict:
    """Phase 9, B7 on one 4096-query bucket: the one-launch form (both
    terms) in turns with two launches of the kernel and the add they need,
    by device time and by events around calls (the serving path's cost);
    each term alone; plain versions and bounds (the distinct blocks the
    bucket touches).  The design it replaced was timed in turns with
    it before it was removed (PERF.md section 6)."""
    from repro_torch.kernels.oos_stage import ops
    from repro_torch.kernels.oos_stage import ref

    local, walk, pair = bucket_inputs(f, model.plan, fit["xt"][:4096])
    opts = dict(name="gaussian", sigma=SIGMA)

    def one():
        return ops.oos_local_walk(*pair, **opts)

    def two():
        return ops.oos_contract(*local, **opts) + ops.oos_contract(*walk,
                                                                   **opts)

    ms, ms_two, t = in_turns(one, two, 50, device=True)
    call, call_two, tc = in_turns(one, two, 50)
    parts = {}
    for stage, sargs in (("oos_local", local), ("oos_walk", walk)):
        parts[stage] = {
            "ms": device_ms(lambda: ops.oos_contract(*sargs, **opts), 50),
            "plain_ms": time_ms(lambda: ref.oos_contract_ref(*sargs, **opts),
                                20),
            "bound_ms": bound_ms(*contract_cost(*sargs))[0],
            "max_abs_err": res[f"{stage}_err"]}
    return kernel_record(
        "oos_contract", "src/repro_torch/csrc/oos_contract.cu",
        "src/repro/kernels/oos_stage/oos_stage.py:64", sl["oos_contract"],
        res["oos_local_walk_err"], ms,
        time_ms(lambda: ref.oos_local_walk_ref(*pair, **opts), 20),
        bound_ms(*pair_cost(*pair)),
        unit="one 4096-query bucket, both terms in one launch; device time",
        two_launches_ms=ms_two,
        turns_pair_ms={"one launch": [t[0], t[3]],
                       "two launches + add": [t[1], t[2]]},
        call_ms=call, two_launches_add_call_ms=call_two,
        call_turns_ms={"one launch": [tc[0], tc[3]],
                       "two launches + add": [tc[1], tc[2]]}, **parts)


def phase_timing(fit, res, served, sw, solv) -> list[dict]:
    """Phase 9: kernel, plain and library times beside the bounds."""
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
    say(f"[9 timing] card: {card()}")
    # B4's and B5's launches on every path this script counts
    paths = {name: {"fit": fl[name], "sweep": sw["launches"][name],
                    "fit_exact (HCK-preconditioned)":
                        solv["exact"]["launches"].get(name, 0),
                    "SLQ surface": solv["slq"]["launches"][name]}
             for name in ("leaf_solve", "leaf_matvec")}

    records += build_timing(args, fl, res)
    dleaf = args["dleaf"]
    records.append(kernel_record(
        "leaf_factor", src + "leaf_factor.cu",
        tpu + "hck_leaf/hck_leaf.py:194", fl["leaf_factor"],
        res["leaf_factor"], time_ms(lambda: lops.leaf_factor(dleaf), 10),
        time_ms(lambda: lref.hck_leaf_factor_ref(dleaf), 10),
        bound_ms(*factor_cost(dleaf)), unit="one launch",
        library_chain_ms=time_ms(lambda: factor_chain(dleaf), 10),
        library_chain="torch.linalg.cholesky + solve_triangular"))
    factor_f64(dleaf, records[-1])
    records.append(solve_timing(args["solve"], fl, res, paths))
    records.append(matvec_timing(args["matvec"], fl, res, paths, {
        "fit": fit["matvec_shapes"], "sweep": sw["matvec_shapes"],
        "SLQ surface": solv["slq"]["matvec_shapes"]}))
    u, b = f.u, model.plan.w_leaf
    records.append(kernel_record(
        "hck_leaf_project", src + "hck_leaf_project.cu",
        tpu + "hck_leaf/hck_leaf.py:233", fl["hck_leaf_project"],
        res["hck_leaf_project"], time_ms(lambda: lops.leaf_project(u, b), 20),
        time_ms(lambda: lref.hck_leaf_project_ref(u, b), 20),
        bound_ms(*project_cost(u, b)),
        library=time_ms(lambda: torch.bmm(u.mT, b), 20), unit="one launch"))
    records.append(contract_timing(f, model, fit, sl, res))
    for rec in records:
        extra = ""
        if "library_chain_ms" in rec:
            extra = (f", chain {rec['library_chain']} "
                     f"{rec['library_chain_ms']:.4f} ms")
        if "previous_ms" in rec:
            extra += (f", previous design {rec['previous_ms']:.4f} ms (in "
                      f"turns: {rec.get('turns_ms', 'per term, below')})")
        if "two_launches_ms" in rec:
            extra += (f", two launches of the new kernel and their add "
                      f"{rec['two_launches_ms']:.4f} ms (in turns: "
                      f"{rec['turns_pair_ms']}); events around calls: one "
                      f"launch {rec['call_ms']:.4f} ms, two launches + add "
                      f"{rec['two_launches_add_call_ms']:.4f} ms (in turns: "
                      f"{rec['call_turns_ms']})")
        elif "call_ms" in rec:
            extra += f", events around calls {rec['call_ms']:.4f} ms"
        if "bound_whole_linv_ms" in rec:
            extra += (f", bound counting all of Linv "
                      f"{rec['bound_whole_linv_ms']:.4f} ms")
        if "launches_by_path" in rec:
            extra += f", launches by path {rec['launches_by_path']}"
        if "launches_by_shape" in rec:
            extra += f", launches by (n0, r, k) {rec['launches_by_shape']}"
        if "direct_sum_floor_ms" in rec:
            extra += (f", direct-sum issue floor "
                      f"{rec['direct_sum_floor_ms']:.4f} ms")
        if "bound_f32_ms" in rec:
            extra += f", f32 CUDA-core bound {rec['bound_f32_ms']:.4f} ms"
        say(f"[9 timing] {rec['name']} ({rec['unit']}): kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']} ms{extra}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), launches {rec['launches']}")
        for part in ("fit_k", "k1", "k12"):
            if part in rec:
                p = rec[part]
                say(f"[9 timing]   {rec['name']} {part} ({p['shape']}): "
                    f"kernel {p['ms']:.4f} ms, "
                    f"events around calls {p['call_ms']:.4f} ms, plain "
                    f"{p['plain_ms']:.4f} ms, library {p['library_ms']:.4f} "
                    f"ms, bound {p['bound_ms']:.4f} ms ({p['bound_by']})")
        for part in ("sigma_levels", "sigma_largest_level", "adiag", "u",
                     "w_levels", "w_largest_level", "oos_local", "oos_walk"):
            if part in rec:
                p = rec[part]
                say(f"[9 timing]   {rec['name']} {part}: kernel "
                    f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound "
                    f"{p['bound_ms']:.4f} ms")
    return records


def device_rows(fn, repeats: int) -> list:
    """``repeats`` calls of ``fn`` under torch.profiler: per device op
    (name, device us a call, launches a call); empty when the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        sync()
    # device-side events only: an aten op's row repeats its kernels' time
    return [(e.key, e.self_device_time_total / repeats, e.count / repeats)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def profile_device(what: str, fn, repeats: int, top: int) -> dict | None:
    """Run ``fn`` ``repeats`` times unprofiled (host clock), then under
    torch.profiler: device time per run by device op, and the busy share.
    Returns {"wall_ms", "device_ms"} per run, or None when the profiler
    recorded no device time."""
    fn()
    sync()
    t = time.perf_counter()
    for _ in range(repeats):
        fn()
    sync()
    wall_ms = (time.perf_counter() - t) * 1e3 / repeats
    rows = device_rows(fn, repeats)
    if not rows:
        say(f"[10 profile] {what}: the profiler recorded no device time: not "
            "measured")
        return None
    rows.sort(key=lambda row: -row[1])
    dev_us = sum(row[1] for row in rows)
    launches = sum(row[2] for row in rows)
    say(f"[10 profile] {what}: wall {wall_ms:.3f} ms unprofiled, device "
        f"{dev_us / 1e3:.3f} ms in {launches:.0f} device ops -> busy share "
        f"{dev_us / 1e3 / wall_ms:.3f}")
    for key, us, count in rows[:top]:
        say(f"[10 profile]   {us:11.2f} us  x{count:6.1f}  {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_us / 1e3}


def phase_profile(fit, eng, sw) -> None:
    """Phase 10: where one full-width fit, one 4096-query request and one
    sigma row of the NLL surface spend their device time."""
    from repro_torch.core import gp, krr
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
    profile_device("one sigma row of mle_grid (sigma 1, 4 lambdas)",
                   lambda: gp.mle_grid(
                       sw["xp"], sw["target"], levels=LEVELS, rank=RANK,
                       sigmas=(SIGMA,), noises=LAMS, jitter=JITTER,
                       plan=sw["plan"]), 1, 16)


def main() -> int:
    """Run every phase; any failure raises and exits non-zero."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch import device
    from repro_torch.kernels import autotune

    # the run's own tile database from its start, so that no database of
    # the home directory steers any phase (phase 8e fills and removes it)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    tile_db = os.path.join(tmp, "tile_db.json")
    os.environ["REPRO_TILE_DB"] = tile_db
    os.environ.pop("REPRO_AUTOTUNE", None)
    autotune.reset_db()

    dev = device.resolve("cuda")
    # the plain versions that this script calls directly, in full f32 (the
    # port's entry points turn TF32 off themselves: phase 5 checks it)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind, smi = phase_device()
    phase_build()
    lm_records = phase_lm(dev)
    fit = phase_fit(dev)
    phase_stream(fit, dev, smi)
    r3 = phase_rank256(fit, dev)
    res = phase_kernels(fit, dev)
    phase_exact(dev)
    served = phase_serve(fit)
    phase_registry(fit, served, dev)
    sw = phase_sweep(fit, dev)
    sres = phase_sweep_gates(fit, sw, dev)
    solv = phase_solvers(fit, sw, dev)
    life = phase_lifecycle(fit, sw, dev)
    prec = phase_precision(fit, sw, dev)
    tune = phase_tuning(fit, tile_db)
    kernels = (phase_timing(fit, res, served, sw, solv)
               + panel_timing(r3) + lifecycle256_timing(r3)
               + sweep_timing(sw, sres)
               + solver_timing(solv["exact"], solv["kres"], tune)
               + lifecycle_timing(fit, life["km"], life["update"],
                                  life["b12"]) + prec + lm_records)
    phase_profile(fit, served["engine"], sw)
    shutil.rmtree(tmp, ignore_errors=True)
    say(f"[end] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
