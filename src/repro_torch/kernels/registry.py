"""Backend registry of the port (counterpart of ``repro.kernels.registry``).

Every compute stage is registered under a ``(stage, backend)`` key, with
the same stage names as the reference.  Backends:

  * ``torch`` -- the plain PyTorch version of the stage (float64 capable);
                 it runs on CPU tensors.
  * ``cuda``  -- the hand-written CUDA C++ kernel; it runs on CUDA tensors.

``SolveConfig.backend="auto"`` follows the tensors: a CUDA tensor goes to
the kernel, a CPU tensor to the plain version.  Forcing a backend onto a
tensor on the other device raises -- there is no silent fallback.  Stages
without a registered implementation belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

BACKENDS = ("torch", "cuda")

#: mixed-precision policies of the build and the prediction (see
#: SolveConfig.precision)
PRECISIONS = ("bf16", "f32", "f64")

#: stages of the reference's registry, same names
STAGES = (
    "leaf_matvec",
    "leaf_solve",
    "leaf_factor",
    "leaf_update",
    "leaf_project",
    "oos_local",
    "oos_walk",
    "build_gram",
    "build_cross",
    "build_gram_dist",
    "build_cross_dist",
    "policy_dist",
    "kernel_matvec",
    "pairwise_kernel",
    "attention",
    "ssd_intra_chunk",
)

#: stages of the port alone: the grouped forms of ``build_gram`` and
#: ``build_cross`` (the build engine) and of ``build_gram_dist`` and
#: ``build_cross_dist`` (the sweep engine, one sigma), every tree level in
#: one launch (the reference launches once per level), and ``oos_local``
#: and ``oos_walk`` of one bucket in one launch (``oos_local_walk``)
PORT_STAGES = (
    "build_gram_levels",
    "build_cross_levels",
    "build_gram_dist_levels",
    "build_cross_dist_levels",
    "oos_local_walk",
)


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    """Hashable stage configuration shared by the port's entry points.

    backend     "auto" follows the device of the stage's tensors (CUDA ->
                "cuda" kernel, CPU -> "torch" plain version); "torch" or
                "cuda" force a backend and raise on a tensor on the other
                device.
    refine_steps  iterative-refinement rounds of
                :func:`repro_torch.core.hmatrix.solve_with_inverse` (each
                is one matvec and one inverse apply).
    leaf_block  rows of a point block that the ``oos_contract`` kernel
                stages in shared memory per step (None = the measured
                block of the autotune tile database where it holds one for
                the bucket, else the largest that fits its shared-memory
                budget).
    precision   mixed-precision policy of the build and the prediction
                (:func:`precision_policy`).  None computes in the dtype
                of the input.  "bf16": the kernel-evaluation *data*
                (points, landmarks, queries, cached distance tiles) is
                cast to bfloat16 before each stage (every backend
                promotes it to float32 before it computes) and every
                factor (Gram, Cholesky, Linv, U, W, the weights) is
                stored and solved in float32.  "f32": data and factors
                in float32.  "f64": both in float64 (the oracle policy).
                The tree and the landmarks are drawn in the input dtype
                before any cast, so a mixed-precision build has the tree
                of the f64 oracle and its gates measure arithmetic error
                alone.  Bounds against the f64 oracle (gaussian kernel,
                jitter 1e-4; the reference's tests/test_precision.py):
                Gram-family factors (adiag, sigma, sigma_cho) relative
                error <= 2e-2 in bf16, <= 1e-4 in f32; the bases U and W
                are amplified by kappa(Sigma) and gated through the
                operator: matvec and predictions <= 5e-2 in bf16, <= 1e-4
                in f32.  The reference documents that inverting
                bf16-built factors needs a ridge of at least about n0 *
                eps_bf16 (~1e-1 at n0 = 32, ~1 at n0 = 128), below which
                the leaf Schur complement goes indefinite (a NaN Cholesky
                factor); a bf16 solve at that floor is within 1e-1.  The
                floor comes from factors rounded to bfloat16 (the
                reference's xla lane stores its stage outputs so); the
                port's stages, like the reference's Pallas lane, write
                float32 factors, whose only bf16 error is the data's
                rounding (ROADMAP C17).  f32 builds invert at any ridge
                the f64 oracle takes.
    checks      runtime health probes (:mod:`repro_torch.runtime.health`):
                finiteness and definiteness of the factors, CG residual
                traces and served predictions at stage boundaries.
                True / False force them on / off; None defers to the
                ``REPRO_STRICT_FINITE`` environment variable at probe
                time.  Off, a probe launches nothing and reads nothing
                back from the card.
    """

    backend: str = "auto"
    refine_steps: int = 2
    leaf_block: int | None = None
    precision: str | None = None
    checks: bool | None = None

    def __post_init__(self):
        if self.backend not in ("auto",) + BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} not in {('auto',) + BACKENDS}")
        if self.precision is not None and self.precision not in PRECISIONS:
            raise ValueError(
                f"precision {self.precision!r} not in {PRECISIONS} (or None)")
        if self.leaf_block is not None and self.leaf_block < 1:
            raise ValueError(f"leaf_block must be >= 1, got {self.leaf_block}")
        if self.refine_steps < 0:
            raise ValueError(
                f"refine_steps must be >= 0, got {self.refine_steps}")
        if self.checks is not None:
            object.__setattr__(self, "checks", bool(self.checks))


DEFAULT_CONFIG = SolveConfig()


def precision_policy(config: SolveConfig | None):
    """(GEMM data dtype, factor dtype) of ``config.precision``, or None
    without a policy (every stage keeps the dtype of its inputs).

    The GEMM dtype is what the kernel-evaluation inputs of a stage are
    cast to before it runs; the factor dtype is what its outputs (Gram
    blocks, Cholesky factors, bases) are stored and solved in.
    """
    if config is None or config.precision is None:
        return None
    gemm = {"bf16": torch.bfloat16, "f32": torch.float32,
            "f64": torch.float64}[config.precision]
    factor = torch.float64 if config.precision == "f64" else torch.float32
    return gemm, factor


_REGISTRY: dict[tuple[str, str], Callable] = {}


def register(stage: str, backend: str):
    """Decorator: register ``fn`` as the ``backend`` implementation of
    ``stage``.  Later registrations override earlier ones."""
    if stage not in STAGES + PORT_STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: "
                         f"{STAGES + PORT_STAGES}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; backends: {BACKENDS}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY[(stage, backend)] = fn
        return fn

    return deco


def get_impl(stage: str, backend: str) -> Callable:
    """Implementation registered for (stage, backend); KeyError if none."""
    try:
        return _REGISTRY[(stage, backend)]
    except KeyError:
        have = sorted(k for k in _REGISTRY if k[0] == stage)
        raise KeyError(
            f"no implementation registered for stage={stage!r} "
            f"backend={backend!r}; registered: {have}") from None


def autotuned_block(stages, *, n0: int, r: int, k: int, d: int,
                    itemsize: int) -> int | None:
    """The measured launch parameter for this shape bucket from the
    autotune tile database (:mod:`repro_torch.kernels.autotune`) of the
    first of ``stages`` (a stage or a tuple) that has one, or None: a
    cold, disabled or corrupt database, no record, a value that is no
    positive int, or any failure of the consult, which degrades to the
    wrapper's own plan and never raises.  A launch pays for it on every
    call, so the cold database returns first and a warm one answers a
    repeated shape from its ``answers``."""
    try:
        from repro_torch.kernels import autotune

        db = autotune.get_db()
        if not db.entries or not autotune.lookups_enabled():
            return None
        args = (stages, n0, r, k, d, itemsize)
        if args not in db.answers:
            for stage in (stages,) if isinstance(stages, str) else stages:
                block = autotune.lookup_block(stage, n0=n0, r=r, k=k, d=d,
                                              itemsize=itemsize)
                if block is not None:
                    break
            db.answers[args] = (block if isinstance(block, int)
                                and block >= 1 else None)
        return db.answers[args]
    except Exception:   # noqa: BLE001 -- the database is best effort
        return None


def resolve_backend(config: SolveConfig | None, stage: str,
                    *tensors: torch.Tensor) -> str:
    """Concrete backend of ``stage`` for ``tensors`` (all on one device).

    "auto" maps a CUDA device to "cuda" and the CPU to "torch".  A forced
    backend must match the device: "torch" on CUDA tensors and "cuda" on
    CPU tensors raise ``ValueError``.  Unlike the reference's, "auto" does
    not read the autotune database's measured winner: a CUDA tensor
    launches the kernel whatever the sweep found (see
    :mod:`repro_torch.kernels.autotune`).
    """
    if stage not in STAGES + PORT_STAGES:
        raise ValueError(f"unknown stage {stage!r}; stages: "
                         f"{STAGES + PORT_STAGES}")
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"stage {stage!r} got tensors on {sorted(kinds)}; "
                         "move them to one device")
    kind = kinds.pop()
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"stage {stage!r}: unsupported device type {kind!r}")
    native = "cuda" if kind == "cuda" else "torch"
    backend = (config or DEFAULT_CONFIG).backend
    if backend == "auto":
        return native
    if backend != native:
        raise ValueError(
            f"backend {backend!r} forced for stage {stage!r} on {kind} "
            f"tensors; the {backend!r} backend runs on "
            f"{'CUDA' if backend == 'cuda' else 'CPU'} tensors only")
    return backend


# Stages of the ported slices.  Lazy imports keep the kernel packages (and
# their builds) out of an import of the registry.

@register("build_gram", "torch")
def _build_gram_torch(points, *, name="gaussian", sigma=1.0, jitter=0.0,
                      want_chol=True):
    """(B,m,d) -> gram (B,m,m) + jitter*m I [, lower Cholesky], plain."""
    from repro_torch.kernels.build_stage.ref import build_gram_ref

    return build_gram_ref(points, name=name, sigma=sigma, jitter=jitter,
                          want_chol=want_chol)


@register("build_gram", "cuda")
def _build_gram_cuda(points, *, name="gaussian", sigma=1.0, jitter=0.0,
                     want_chol=True):
    """(B,m,d) -> gram (B,m,m) + jitter*m I [, lower Cholesky], CUDA."""
    from repro_torch.kernels.build_stage.ops import build_gram

    return build_gram(points, name=name, sigma=sigma, jitter=jitter,
                      want_chol=want_chol)


@register("build_cross", "torch")
def _build_cross_torch(points, landmarks, linv, *, name="gaussian",
                       sigma=1.0, row_tile=None):
    """(B,m,d),(B,r,d),(B,r,r) -> K(P,Z) Linv^T Linv (B,m,r), plain."""
    del row_tile
    from repro_torch.kernels.build_stage.ref import build_cross_ref

    return build_cross_ref(points, landmarks, linv, name=name, sigma=sigma)


@register("build_cross", "cuda")
def _build_cross_cuda(points, landmarks, linv, *, name="gaussian",
                      sigma=1.0, row_tile=None):
    """(B,m,d),(B,r,d),(B,r,r) -> K(P,Z) Linv^T Linv (B,m,r), CUDA."""
    from repro_torch.kernels.build_stage.ops import build_cross

    return build_cross(points, landmarks, linv, name=name, sigma=sigma,
                       row_tile=row_tile)


@register("build_gram_levels", "torch")
def _build_gram_levels_torch(points, *, name="gaussian", sigma=1.0,
                             jitter=0.0, want_chol=True):
    """Per level (B,m,d) -> (K(P,P) + jitter*m I, lower Cholesky or None),
    one want_chol for all levels, plain."""
    from repro_torch.kernels.build_stage.ref import build_gram_levels_ref

    return build_gram_levels_ref(points, name=name, sigma=sigma,
                                 jitter=jitter, want_chol=want_chol)


@register("build_gram_levels", "cuda")
def _build_gram_levels_cuda(points, *, name="gaussian", sigma=1.0,
                            jitter=0.0, want_chol=True):
    """Per level (B,m,d) -> (K(P,P) + jitter*m I, lower Cholesky or None),
    one want_chol for all levels, one CUDA launch."""
    from repro_torch.kernels.build_stage.ops import build_gram_levels

    return build_gram_levels(points, name=name, sigma=sigma, jitter=jitter,
                             want_chol=want_chol)


@register("build_cross_levels", "torch")
def _build_cross_levels_torch(points, landmarks, linvs, *, name="gaussian",
                              sigma=1.0):
    """Per level (B,m,d),(B,r,d),(B,r,r) -> K(P,Z) Linv^T Linv, plain."""
    from repro_torch.kernels.build_stage.ref import build_cross_levels_ref

    return build_cross_levels_ref(points, landmarks, linvs, name=name,
                                  sigma=sigma)


@register("build_cross_levels", "cuda")
def _build_cross_levels_cuda(points, landmarks, linvs, *, name="gaussian",
                             sigma=1.0):
    """Per level (B,m,d),(B,r,d),(B,r,r) -> K(P,Z) Linv^T Linv, one CUDA
    launch."""
    from repro_torch.kernels.build_stage.ops import build_cross_levels

    return build_cross_levels(points, landmarks, linvs, name=name,
                              sigma=sigma)


@register("build_gram_dist", "torch")
def _build_gram_dist_torch(dist, *, name="gaussian", sigma=1.0, jitter=0.0,
                           want_chol=True):
    """(B,m,m) distances -> kappa(D) + jitter*m I [, lower Cholesky], plain."""
    from repro_torch.kernels.build_stage.ref import build_gram_dist_ref

    return build_gram_dist_ref(dist, name=name, sigma=sigma, jitter=jitter,
                               want_chol=want_chol)


@register("build_gram_dist", "cuda")
def _build_gram_dist_cuda(dist, *, name="gaussian", sigma=1.0, jitter=0.0,
                          want_chol=True):
    """(B,m,m) distances -> kappa(D) + jitter*m I [, lower Cholesky], CUDA."""
    from repro_torch.kernels.build_stage.ops import build_gram_dist

    return build_gram_dist(dist, name=name, sigma=sigma, jitter=jitter,
                           want_chol=want_chol)


@register("build_cross_dist", "torch")
def _build_cross_dist_torch(dist, linv, *, name="gaussian", sigma=1.0,
                            row_tile=None):
    """(B,m,r),(B,r,r) -> kappa(D) Linv^T Linv (B,m,r), plain."""
    del row_tile
    from repro_torch.kernels.build_stage.ref import build_cross_dist_ref

    return build_cross_dist_ref(dist, linv, name=name, sigma=sigma)


@register("build_cross_dist", "cuda")
def _build_cross_dist_cuda(dist, linv, *, name="gaussian", sigma=1.0,
                           row_tile=None):
    """(B,m,r),(B,r,r) -> kappa(D) Linv^T Linv (B,m,r), CUDA."""
    from repro_torch.kernels.build_stage.ops import build_cross_dist

    return build_cross_dist(dist, linv, name=name, sigma=sigma,
                            row_tile=row_tile)


@register("build_gram_dist_levels", "torch")
def _build_gram_dist_levels_torch(dists, *, name="gaussian", sigma=1.0,
                                  jitter=0.0):
    """Per level (B,m,m) distances -> (kappa(D) + jitter*m I, lower
    Cholesky), plain."""
    from repro_torch.kernels.build_stage.ref import build_gram_dist_levels_ref

    return build_gram_dist_levels_ref(dists, name=name, sigma=sigma,
                                      jitter=jitter)


@register("build_gram_dist_levels", "cuda")
def _build_gram_dist_levels_cuda(dists, *, name="gaussian", sigma=1.0,
                                 jitter=0.0):
    """Per level (B,m,m) distances -> (kappa(D) + jitter*m I, lower
    Cholesky), one CUDA launch."""
    from repro_torch.kernels.build_stage.ops import build_gram_dist_levels

    return build_gram_dist_levels(dists, name=name, sigma=sigma,
                                  jitter=jitter)


@register("build_cross_dist_levels", "torch")
def _build_cross_dist_levels_torch(dists, linvs, *, name="gaussian",
                                   sigma=1.0):
    """Per level (B,m,r),(B,r,r) -> kappa(D) Linv^T Linv, plain."""
    from repro_torch.kernels.build_stage.ref import build_cross_dist_levels_ref

    return build_cross_dist_levels_ref(dists, linvs, name=name, sigma=sigma)


@register("build_cross_dist_levels", "cuda")
def _build_cross_dist_levels_cuda(dists, linvs, *, name="gaussian",
                                  sigma=1.0):
    """Per level (B,m,r),(B,r,r) -> kappa(D) Linv^T Linv, one CUDA launch."""
    from repro_torch.kernels.build_stage.ops import build_cross_dist_levels

    return build_cross_dist_levels(dists, linvs, name=name, sigma=sigma)


@register("leaf_factor", "torch")
def _leaf_factor_torch(dleaf):
    """(P,n0,n0) SPD -> (L, L^-1), both lower, plain version."""
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_factor_ref

    return hck_leaf_factor_ref(dleaf)


@register("leaf_factor", "cuda")
def _leaf_factor_cuda(dleaf):
    """(P,n0,n0) SPD -> (L, L^-1), both lower, CUDA kernel."""
    from repro_torch.kernels.hck_leaf.ops import leaf_factor

    return leaf_factor(dleaf)


@register("leaf_matvec", "torch")
def _leaf_matvec_torch(adiag, u, b):
    """(P,n0,n0),(P,n0,r),(P,n0,k) -> y = A b, c = U^T b, plain version."""
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_matvec_ref

    return hck_leaf_matvec_ref(adiag, u, b)


@register("leaf_matvec", "cuda")
def _leaf_matvec_cuda(adiag, u, b):
    """(P,n0,n0),(P,n0,r),(P,n0,k) -> y = A b, c = U^T b, CUDA kernel."""
    from repro_torch.kernels.hck_leaf.ops import leaf_matvec

    return leaf_matvec(adiag, u, b)


@register("leaf_solve", "torch")
def _leaf_solve_torch(linv, u, sig, b):
    """x = Linv^T Linv b + U Sig U^T b, c = U^T b, plain version."""
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_solve_ref

    return hck_leaf_solve_ref(linv, u, sig, b)


@register("leaf_solve", "cuda")
def _leaf_solve_cuda(linv, u, sig, b):
    """x = Linv^T Linv b + U Sig U^T b, c = U^T b, CUDA kernel."""
    from repro_torch.kernels.hck_leaf.ops import leaf_solve

    return leaf_solve(linv, u, sig, b)


@register("leaf_project", "torch")
def _leaf_project_torch(u, b):
    """(P,n0,r),(P,n0,k) -> c (P,r,k) = U^T b, plain version."""
    from repro_torch.kernels.hck_leaf.ref import hck_leaf_project_ref

    return hck_leaf_project_ref(u, b)


@register("leaf_project", "cuda")
def _leaf_project_cuda(u, b):
    """(P,n0,r),(P,n0,k) -> c (P,r,k) = U^T b, CUDA kernel."""
    from repro_torch.kernels.hck_leaf.ops import leaf_project

    return leaf_project(u, b)


@register("oos_local", "torch")
@register("oos_walk", "torch")
def _oos_contract_torch(points, weights, queries, point_index, weight_index,
                        *, name="gaussian", sigma=1.0, leaf_block=None):
    """z_i = W[widx_i]^T k(P[pidx_i], x_i), plain version."""
    del leaf_block
    from repro_torch.kernels.oos_stage.ref import oos_contract_ref

    return oos_contract_ref(points, weights, queries, point_index,
                            weight_index, name=name, sigma=sigma)


@register("oos_local", "cuda")
@register("oos_walk", "cuda")
def _oos_contract_cuda(points, weights, queries, point_index, weight_index,
                       *, name="gaussian", sigma=1.0, leaf_block=None):
    """z_i = W[widx_i]^T k(P[pidx_i], x_i), CUDA kernel."""
    from repro_torch.kernels.oos_stage.ops import oos_contract

    return oos_contract(points, weights, queries, point_index, weight_index,
                        name=name, sigma=sigma, leaf_block=leaf_block)


@register("oos_local_walk", "torch")
def _oos_local_walk_torch(xl, wl, lm, ct, queries, leaf_index, parent_index,
                          *, name="gaussian", sigma=1.0, leaf_block=None):
    """oos_local + oos_walk of each query summed, plain version."""
    del leaf_block
    from repro_torch.kernels.oos_stage.ref import oos_local_walk_ref

    return oos_local_walk_ref(xl, wl, lm, ct, queries, leaf_index,
                              parent_index, name=name, sigma=sigma)


@register("oos_local_walk", "cuda")
def _oos_local_walk_cuda(xl, wl, lm, ct, queries, leaf_index, parent_index,
                         *, name="gaussian", sigma=1.0, leaf_block=None):
    """oos_local + oos_walk of each query in one CUDA launch."""
    from repro_torch.kernels.oos_stage.ops import oos_local_walk

    return oos_local_walk(xl, wl, lm, ct, queries, leaf_index, parent_index,
                          name=name, sigma=sigma, leaf_block=leaf_block)


@register("kernel_matvec", "torch")
def _kernel_matvec_torch(xc, y, v, *, name="gaussian", sigma=1.0):
    """(b,d),(m,d),(m,k) -> z (b,k) = K(Xc, Y) V (dtype-preserving), plain."""
    from repro_torch.kernels.matvec_stage.ref import kernel_matvec_ref

    return kernel_matvec_ref(xc, y, v, name=name, sigma=sigma)


@register("kernel_matvec", "cuda")
def _kernel_matvec_cuda(xc, y, v, *, name="gaussian", sigma=1.0):
    """(b,d),(m,d),(m,k) -> z (b,k) = K(Xc, Y) V, CUDA kernel."""
    from repro_torch.kernels.matvec_stage.ops import kernel_matvec

    return kernel_matvec(xc, y, v, name=name, sigma=sigma)


@register("pairwise_kernel", "torch")
def _pairwise_kernel_torch(x, y, *, name="gaussian", sigma=1.0):
    """(n,d),(m,d) -> K(X, Y) (n,m) in float32, plain version."""
    from repro_torch.kernels.kernel_tile.ref import pairwise_kernel_ref

    return pairwise_kernel_ref(x, y, name=name, sigma=sigma)


@register("pairwise_kernel", "cuda")
def _pairwise_kernel_cuda(x, y, *, name="gaussian", sigma=1.0):
    """(n,d),(m,d) -> K(X, Y) (n,m) in float32, CUDA kernel."""
    from repro_torch.kernels.kernel_tile.ops import pairwise_kernel

    return pairwise_kernel(x, y, name=name, sigma=sigma)


@register("policy_dist", "torch")
def _policy_dist_torch(blocks, centers, *, metric="l2"):
    """(B,m,d),(B,r,d) -> (B,m,r) squared-L2 / L1 distances, plain."""
    from repro_torch.kernels.policy_stage.ref import policy_dist_ref

    return policy_dist_ref(blocks, centers, metric=metric)


@register("policy_dist", "cuda")
def _policy_dist_cuda(blocks, centers, *, metric="l2"):
    """(B,m,d),(B,r,d) -> (B,m,r) squared-L2 / L1 distances, CUDA kernel."""
    from repro_torch.kernels.policy_stage.ops import policy_dist

    return policy_dist(blocks, centers, metric=metric)


@register("leaf_update", "torch")
def _leaf_update_torch(lo, linv, b, c):
    """Bordered extension of the leaf (L, L^-1) pair by k rows, plain."""
    from repro_torch.kernels.update_stage.ref import leaf_update_ref

    return leaf_update_ref(lo, linv, b, c)


@register("leaf_update", "cuda")
def _leaf_update_cuda(lo, linv, b, c):
    """Bordered extension of the leaf (L, L^-1) pair by k rows, CUDA."""
    from repro_torch.kernels.update_stage.ops import leaf_update

    return leaf_update(lo, linv, b, c)


@register("attention", "torch")
def _attention_torch(q, k, v, *, causal=True, window=0):
    """(B,Hq,S,D),(B,Hkv,S,D)x2 -> GQA attention (B,Hq,S,D), plain."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    return attention_ref(q, k, v, causal=causal, window=window)


@register("attention", "cuda")
def _attention_cuda(q, k, v, *, causal=True, window=0):
    """(B,Hq,S,D),(B,Hkv,S,D)x2 -> GQA attention (B,Hq,S,D), CUDA kernel."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    return flash_attention(q, k, v, causal=causal, window=window)


@register("ssd_intra_chunk", "torch")
def _ssd_intra_chunk_torch(c, b, xdt, cs):
    """(BH,nc,Q,N)x2,(BH,nc,Q,P),(BH,nc,Q) -> SSD intra-chunk y, plain."""
    from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

    return ssd_intra_chunk_ref(c, b, xdt, cs)


@register("ssd_intra_chunk", "cuda")
def _ssd_intra_chunk_cuda(c, b, xdt, cs):
    """(BH,nc,Q,N)x2,(BH,nc,Q,P),(BH,nc,Q) -> SSD intra-chunk y, CUDA."""
    from repro_torch.kernels.ssd_chunk.ops import ssd_intra_chunk

    return ssd_intra_chunk(c, b, xdt, cs)
