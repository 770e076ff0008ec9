"""Plain PyTorch versions of the two build stages of Algorithm 2.

Both are per-node maps batched over every node of one tree level
(counterparts of ``repro.kernels.build_stage.ref``):

  * ``build_gram``:  P_b (m, d) -> G_b = K(P_b, P_b) + jitter*m I  (m, m)
                     and, with ``want_chol``, its lower Cholesky factor;
  * ``build_cross``: P_b (m, d), Z_b (r, d), Linv_b (r, r) ->
                     U_b = K(P_b, Z_b) Linv_b^T Linv_b              (m, r)
                     with ``Linv_b`` the inverse Cholesky factor of the
                     parent's middle factor (``Sigma^-1 = Linv^T Linv``).

and their grouped forms over a list of tree levels (one launch each on
the card), ``build_gram_levels`` (a factor where asked) and
``build_cross_levels``, each a loop over the per-level plain versions.

The base kernel is evaluated through :mod:`repro_torch.core.kernels_fn`,
so in float64 both agree with the reference's ``xla`` path to round-off.
A block that is not positive definite gets a factor whose lower triangle
is NaN, the reference's failure mode, instead of an exception.  Each plain
version promotes bfloat16 inputs (the data of a mixed-precision policy)
to float32 before it computes and keeps float64, as the reference's do.

The sweep engine (:class:`repro_torch.core.hck.SweepPlan`) adds the
distance-cached variants: :func:`pairwise_dist_ref` computes the
bandwidth-independent metric distances once per grid, and every per-sigma
rebuild is the kernel nonlinearity plus the factorization only:

  * ``build_gram_dist``:  D_b (m, m) -> kappa_sigma(D_b) + jitter*m I
                          [+ lower Cholesky];
  * ``build_cross_dist``: D_b (m, r), Linv_b (r, r) ->
                          kappa_sigma(D_b) Linv_b^T Linv_b;

and their grouped forms over a list of levels, ``build_gram_dist_levels``
(with the factor) and ``build_cross_dist_levels``, each a loop over the
per-level plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_fn import _sqdist, get_kernel, kernel_epilogue


def promote(a: torch.Tensor) -> torch.Tensor:
    """``a`` in at least float32: bfloat16 (or float16) promoted, float32
    and float64 kept (the reference's ``_f``)."""
    return a if a.dtype in (torch.float32, torch.float64) else a.float()


def nan_failed_factors(chol: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """NaN the lower triangle of the (B, m, m) factors whose
    ``torch.linalg.cholesky_ex`` info is nonzero (the block was not
    positive definite), as the reference's Cholesky does."""
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(chol, float("nan")).tril(), chol)


def build_gram_ref(
    points: torch.Tensor, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, m, d) -> gram (B, m, m) [+ lower Cholesky (B, m, m) or None]."""
    build_gram_ref.calls += 1
    points = promote(points)
    m = points.shape[1]
    gram = get_kernel(name)(points, points, sigma=sigma)
    gram = gram + (jitter * m) * torch.eye(m, dtype=gram.dtype,
                                           device=gram.device)
    if not want_chol:
        return gram, None
    chol, info = torch.linalg.cholesky_ex(gram)
    return gram, nan_failed_factors(chol, info)


def build_cross_ref(
    points: torch.Tensor, landmarks: torch.Tensor, linv: torch.Tensor, *,
    name: str = "gaussian", sigma: float = 1.0,
) -> torch.Tensor:
    """(B, m, d), (B, r, d), (B, r, r) -> U (B, m, r) = K(P, Z) Linv^T Linv."""
    build_cross_ref.calls += 1
    points, landmarks, linv = map(promote, (points, landmarks, linv))
    kxu = get_kernel(name)(points, landmarks, sigma=sigma)       # (B, m, r)
    return (kxu @ linv.mT) @ linv


def build_gram_levels_ref(
    points, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """Per level (B_l, m_l, d) -> (gram, lower Cholesky or None): the
    per-level plain version on each."""
    build_gram_levels_ref.calls += 1
    return [build_gram_ref(p, name=name, sigma=sigma, jitter=jitter,
                           want_chol=want_chol) for p in points]


def build_cross_levels_ref(
    points, landmarks, linvs, *, name: str = "gaussian", sigma: float = 1.0,
) -> list[torch.Tensor]:
    """Per level (B_l, m_l, d), (B_l, r, d), (B_l, r, r) -> U (B_l, m_l,
    r): the per-level plain version on each."""
    build_cross_levels_ref.calls += 1
    return [build_cross_ref(p, z, li, name=name, sigma=sigma)
            for p, z, li in zip(points, landmarks, linvs)]


def direct_dist(x: torch.Tensor, y: torch.Tensor,
                metric: str) -> torch.Tensor:
    """(B, m, d), (B, r, d) -> (B, m, r): sum over the features, in feature
    order, of (x - y)^2 ("l2", squared Euclidean, one multiply-add per
    feature) or |x - y| ("l1"), as the kernels sum them.  The loop over
    features holds two (B, m, r) buffers, never a (B, m, r, d) difference
    tensor."""
    out = x.new_zeros((x.shape[0], x.shape[1], y.shape[1]))
    for t in range(x.shape[2]):
        diff = x[:, :, None, t] - y[:, None, :, t]
        if metric == "l2":
            out.addcmul_(diff, diff)
        else:
            out += diff.abs()
    return out


def pairwise_dist_ref(x: torch.Tensor, y: torch.Tensor,
                      metric: str) -> torch.Tensor:
    """Batched metric distances: (B, m, d), (B, r, d) -> (B, m, r).

    ``"l2"`` is the SQUARED Euclidean distance, ``"l1"`` the Manhattan
    one.  On the CPU "l2" goes through the norm identity of
    :func:`repro_torch.core.kernels_fn._sqdist`, as the reference's plan
    pass does, so float64 plans agree with it to round-off.  On the card
    "l2" is :func:`direct_dist`, which sums as the ``build_gram`` and
    ``build_cross`` kernels do, so the factors of a plan match those of
    ``build_hck`` in float32 too (the identity cancels for points far
    from the origin).  "l1" is always :func:`direct_dist`.
    """
    if metric not in ("l2", "l1"):
        raise ValueError(f"unknown metric {metric!r}; have ('l2', 'l1')")
    if metric == "l2" and x.device.type == "cpu":
        return _sqdist(x, y)
    return direct_dist(x, y, metric)


def build_gram_dist_ref(
    dist: torch.Tensor, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0, want_chol: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(B, m, m) cached distances -> gram (B, m, m) = kappa_sigma(D) +
    jitter*m I [+ lower Cholesky (B, m, m) or None]."""
    build_gram_dist_ref.calls += 1
    dist = promote(dist)
    m = dist.shape[1]
    gram = kernel_epilogue(name, sigma)(dist)
    gram = gram + (jitter * m) * torch.eye(m, dtype=gram.dtype,
                                           device=gram.device)
    if not want_chol:
        return gram, None
    chol, info = torch.linalg.cholesky_ex(gram)
    return gram, nan_failed_factors(chol, info)


def build_cross_dist_ref(
    dist: torch.Tensor, linv: torch.Tensor, *, name: str = "gaussian",
    sigma: float = 1.0,
) -> torch.Tensor:
    """(B, m, r) cached distances, (B, r, r) -> U (B, m, r) =
    kappa_sigma(D) Linv^T Linv, with Linv the parent's inverse Cholesky
    factor at this sigma."""
    build_cross_dist_ref.calls += 1
    dist, linv = promote(dist), promote(linv)
    return (kernel_epilogue(name, sigma)(dist) @ linv.mT) @ linv


def build_gram_dist_levels_ref(
    dists, *, name: str = "gaussian", sigma: float = 1.0,
    jitter: float = 0.0,
) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per level (B_l, m_l, m_l) -> (gram, lower Cholesky): the per-level
    plain version on each."""
    build_gram_dist_levels_ref.calls += 1
    return [build_gram_dist_ref(d, name=name, sigma=sigma, jitter=jitter)
            for d in dists]


def build_cross_dist_levels_ref(
    dists, linvs, *, name: str = "gaussian", sigma: float = 1.0,
) -> list[torch.Tensor]:
    """Per level (B_l, m_l, r), (B_l, r, r) -> U (B_l, m_l, r): the
    per-level plain version on each."""
    build_cross_dist_levels_ref.calls += 1
    return [build_cross_dist_ref(d, li, name=name, sigma=sigma)
            for d, li in zip(dists, linvs)]


build_gram_ref.calls = 0
build_cross_ref.calls = 0
build_gram_levels_ref.calls = 0
build_cross_levels_ref.calls = 0
build_gram_dist_ref.calls = 0
build_cross_dist_ref.calls = 0
build_gram_dist_levels_ref.calls = 0
build_cross_dist_levels_ref.calls = 0
