"""Gaussian-process view of the HCK kernel (counterpart of
``repro.core.gp``; paper section 1.1, Eq. 3-4 and Eq. 25).

  * posterior mean   -- Eq. 3 with K = K_hck + noise I (Algorithm 2 + 3)
  * posterior var    -- the diagonal of Eq. 4, O(n) per query (it builds
                        the explicit k_hck(X, x) vector of each query)
  * log-likelihood   -- Eq. 25 with the Algorithm-2 log-determinant

:func:`mle_objective` is the negative log marginal likelihood as a
function of (log sigma, log noise) with the tree and landmarks frozen;
:func:`mle_grid` evaluates it over a whole sigma x lambda grid through the
sweep engine (one plan, per sigma one :func:`~repro_torch.core.hck.
sweep_factors` pass and one multi-ridge inversion, or, with
``logdet="slq"``, stochastic Lanczos quadrature and PCG).  On the card every
stage is a CUDA kernel.  The kernels have no backward pass: a gradient of
:func:`mle_objective` flows through the plain versions on the CPU, and on
the card inputs that need a gradient raise.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from repro_torch import device as _device
from repro_torch.core import hmatrix, oos
from repro_torch.core.hck import (HCKFactors, SweepPlan, build_hck,
                                  build_sweep_plan, landmark_indices,
                                  sweep_factors)
from repro_torch.core.kernels_fn import KERNEL_METRIC, BaseKernel
from repro_torch.core.partition import rp_directions
from repro_torch.kernels.registry import SolveConfig
from repro_torch.precision import entry_point
from repro_torch.runtime import health

Tensor = torch.Tensor


@dataclasses.dataclass
class HCKGaussianProcess:
    """Fitted HCK GP: structured inverse, dual coefficients, OOS plan.

    ``alpha`` and ``plan`` are in tree order; ``posterior_mean`` serves
    (q, d) query batches through the shape-bucketed prediction engine, and
    ``posterior_var`` and ``log_marginal_likelihood`` reuse the structured
    inverse (``solve_config`` selects the backends of all of them).
    """

    kernel: BaseKernel
    factors: HCKFactors
    inv: hmatrix.InverseFactors
    alpha: Tensor              # (n, 1) = (K + noise I)^-1 y, tree order
    plan: oos.OOSPlan
    noise: float
    solve_config: SolveConfig | None = None

    def __post_init__(self):
        self._engine = None

    @property
    def engine(self):
        """Shape-bucketed prediction service for the posterior mean."""
        from repro_torch.serving.predict_service import PredictEngine

        return PredictEngine.attach(self)

    def posterior_mean(self, queries: Tensor) -> Tensor:
        """Eq. 3 posterior mean: (q, d) -> (q,)."""
        return self.engine(queries)[:, 0]

    def posterior_var(self, queries: Tensor) -> Tensor:
        """Diagonal of Eq. 4: O(n) per query (explicit k_hck vectors), with
        one multi-column structured-inverse apply for the whole batch."""
        vs = oos.oos_reference_batch(self.factors, queries, self.kernel).T
        kinv_vs = hmatrix.apply_inverse(self.inv, vs.contiguous(),
                                        self.solve_config)
        pts = queries[:, None, :]
        kxx = self.kernel.cross(pts, pts)[:, 0, 0] + self.kernel.jitter
        return kxx - torch.sum(vs * kinv_vs, dim=0)

    def log_marginal_likelihood(self, y_sorted: Tensor) -> Tensor:
        """Eq. 25 through the Algorithm-2 log-determinant (y in tree
        order)."""
        n = y_sorted.shape[0]
        quad = torch.sum(y_sorted * self.alpha[:, 0])
        return (-0.5 * quad - 0.5 * self.inv.logabsdet
                - 0.5 * n * math.log(2 * math.pi))


@entry_point
def fit_gp(
    x, y, *, kernel: BaseKernel, noise: float, rank: int, levels: int,
    solve_config: SolveConfig | None = None, device=None,
    generator: torch.Generator | None = None, directions=None,
    landmark_index=None,
) -> HCKGaussianProcess:
    """Fit the HCK GP: the structured inverse of (K_hck + noise I) and the
    Algorithm-3 plan of the posterior mean.

    ``x`` (n, d) with n divisible by 2**levels, ``y`` (n,).  ``device``:
    None is the CUDA card (raises without one), "cpu" the plain path.
    ``generator`` (default seeded 0 on ``device``), or ``directions`` and
    ``landmark_index``, give the tree and landmark draws (see
    :func:`repro_torch.core.hck.build_hck`).  With ``solve_config.checks``
    (or ``REPRO_STRICT_FINITE``) the factors, the inverse Cholesky and the
    coefficients are probed (:mod:`repro_torch.runtime.health`).
    """
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    factors = build_hck(x, levels=levels, rank=rank, kernel=kernel,
                        config=solve_config, directions=directions,
                        landmark_index=landmark_index, generator=generator)
    health.probe_factors(factors, solve_config, op="build")
    y_sorted = y.to(x.dtype)[factors.tree.perm][:, None]
    inv = hmatrix.invert(factors, ridge=noise, config=solve_config)
    if inv.linv is not None:
        health.check_finite("leaf_factor", inv.linv, config=solve_config,
                            leaf_axis=0, detail="inverse Cholesky (gp)")
    alpha = hmatrix.apply_inverse(inv, y_sorted, solve_config)
    health.check_finite("solve", alpha, config=solve_config,
                        detail="dual coefficients (gp)")
    plan = oos.prepare(factors, alpha, solve_config)
    return HCKGaussianProcess(kernel, factors, inv, alpha, plan, noise,
                              solve_config)


def _check_metric_kernel(name: str) -> None:
    if name not in KERNEL_METRIC:
        raise ValueError(
            f"kernel {name!r} is not sigma-foldable: the bandwidth is "
            "applied as x * exp(-log_sigma), which needs k_sigma(x, y) = "
            "k_1(x / sigma, y / sigma), true only for the kernels of "
            f"KERNEL_METRIC ({sorted(KERNEL_METRIC)})")


def _frozen_draws(x: Tensor, levels: int, rank: int, directions,
                  landmark_index, generator):
    """Directions and landmark row indices of a tree over ``x``, drawn once
    (in :func:`build_hck`'s order) unless injected, so that every
    evaluation of the objective sees the same tree and landmarks."""
    n, d = x.shape
    if directions is None:
        directions = [rp_directions(1 << lvl, d, dtype=x.dtype,
                                    device=x.device, generator=generator)
                      for lvl in range(levels)]
    if landmark_index is None:
        landmark_index = [landmark_indices(1 << lvl, n >> lvl, rank,
                                           device=x.device,
                                           generator=generator)
                          for lvl in range(levels)]
    return directions, landmark_index


def mle_objective(
    x, y, *, levels: int, rank: int, name: str = "gaussian",
    solve_config: SolveConfig | None = None, device=None,
    generator: torch.Generator | None = None, directions=None,
    landmark_index=None,
):
    """f(log_sigma, log_noise) -> the negative log marginal likelihood.

    The tree and landmark draws are frozen (drawn once from ``generator``,
    or injected), so the surface is deterministic -- the paper's section
    5.1 point that stable surfaces are a prerequisite of parameter
    estimation.  The bandwidth is folded into the data (``x *
    exp(-log_sigma)``), which holds for the kernels of ``KERNEL_METRIC``
    only; any other ``name`` raises.  The random-projection split is scale
    invariant, so every sigma builds the same tree.

    On CPU tensors the value is differentiable in both arguments through
    the plain versions (autograd).  On the card the kernels have no
    backward pass, and arguments that need a gradient raise.  For a whole
    grid prefer :func:`mle_grid`.
    """
    _check_metric_kernel(name)
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    directions, landmark_index = _frozen_draws(
        x, levels, rank, directions, landmark_index, generator)

    def nll(log_sigma, log_noise) -> Tensor:
        log_sigma = torch.as_tensor(log_sigma, dtype=x.dtype, device=dev)
        log_noise = torch.as_tensor(log_noise, dtype=x.dtype, device=dev)
        factors = build_hck(x * torch.exp(-log_sigma), levels=levels,
                            rank=rank, kernel=BaseKernel(name, sigma=1.0),
                            config=solve_config, directions=directions,
                            landmark_index=landmark_index)
        y_sorted = y.to(x.dtype)[factors.tree.perm][:, None]
        inv = hmatrix.invert(factors, ridge=torch.exp(log_noise),
                             config=solve_config)
        alpha = hmatrix.apply_inverse(inv, y_sorted, solve_config)
        n = y_sorted.shape[0]
        quad = torch.sum(y_sorted[:, 0] * alpha[:, 0])
        return (0.5 * quad + 0.5 * inv.logabsdet
                + 0.5 * n * math.log(2 * math.pi))

    return nll


def slq_row(factors: HCKFactors, y_sorted: Tensor, noises, *,
            probe_vectors: Tensor, iters: int, ridge0: float, cg_tol: float,
            cg_maxiter: int, config: SolveConfig | None = None,
            sigma: float | None = None) -> tuple[Tensor, Tensor]:
    """One bandwidth's row of the SLQ surface of :func:`mle_grid`: the
    quadratic terms y^T (K_hck + lam_g I)^-1 y (G,) by PCG through the
    Algorithm-1 matvec, preconditioned by the exact Algorithm-2 inverse at
    ``ridge0``, and the SLQ log-determinants (G,) from one Lanczos pass per
    probe.  ``y_sorted`` (n, 1) is in tree order.  A PCG solve that misses
    ``cg_tol`` warns (``sigma`` names the bandwidth in the warning)."""
    from repro_torch.solvers.cg import pcg
    from repro_torch.solvers.slq import slq_logdet

    n = y_sorted.shape[0]
    inv0 = hmatrix.invert(factors, ridge=ridge0, config=config)

    def mv(v):
        return hmatrix.matvec(factors, v, config)

    def precond(r):
        return hmatrix.apply_inverse(inv0, r, config)

    lds = slq_logdet(mv, n, ridges=noises, iters=iters,
                     probe_vectors=probe_vectors)
    quads = []
    for noise in noises:
        res = pcg(mv, y_sorted, ridge=noise, precond=precond, tol=cg_tol,
                  maxiter=cg_maxiter)
        if not res.converged:
            # an unconverged quadratic term would silently corrupt the
            # surface that argmin-based model selection reads
            warnings.warn(
                f"mle_grid(logdet='slq'): PCG for sigma={sigma} noise="
                f"{noise} stopped at {res.iterations} iterations with "
                f"relative residual {float(res.residuals[res.iterations]):.2e}"
                f" (> cg_tol={cg_tol}); raise cg_maxiter or move the "
                "reference ridge closer to this grid point", stacklevel=3)
        quads.append(torch.sum(y_sorted[:, 0] * res.x[:, 0]))
    return torch.stack(quads), lds


@entry_point
def mle_grid(
    x, y, *, levels: int, rank: int, sigmas, noises, name: str = "gaussian",
    jitter: float = 1e-5, solve_config: SolveConfig | None = None,
    logdet: str = "exact", plan: SweepPlan | None = None, device=None,
    generator: torch.Generator | None = None, directions=None,
    landmark_index=None, slq_probes: int = 32, slq_iters: int = 48,
    slq_probe_vectors=None, slq_generator: torch.Generator | None = None,
    cg_tol: float = 1e-8, cg_maxiter: int = 200,
) -> Tensor:
    """Eq. 25 NLL over a sigma x lambda grid through the sweep engine: the
    (S, G) surface.

    One :func:`~repro_torch.core.hck.build_sweep_plan` (the tree, the
    landmarks and the distances are bandwidth-independent) serves the whole
    grid; per sigma, :func:`~repro_torch.core.hck.sweep_factors`
    instantiates the factors from the cached tiles and
    :func:`~repro_torch.core.hmatrix.invert_multi` inverts all noises
    with one leaf-factorization launch.  Entry (s, g) matches
    ``mle_objective(...)(log(sigmas[s]), log(noises[g]))`` under the same
    draws to round-off.

    ``plan`` reuses a plan built beforehand from ``x`` (with ``name``'s
    metric and ``levels`` and ``rank``); otherwise one is built from
    ``generator`` or the injected draws.

    ``logdet="slq"`` replaces the per-ridge exact Algorithm-2 recursion by
    stochastic Lanczos quadrature through the O(n r) Algorithm-1 matvec
    (:func:`slq_row`): per sigma ONE exact inversion, at the grid's
    geometric-mean ridge, preconditions a PCG solve per ridge
    (``cg_tol``, ``cg_maxiter``; a miss warns), and ``slq_probes``
    Lanczos recurrences of ``slq_iters`` steps give the log-determinant of
    every ridge.  The Rademacher probes are ``slq_probe_vectors``
    (slq_probes, n), else drawn once from ``slq_generator`` (default
    seeded 42 on the device) and shared by every sigma, as the reference
    shares its key.
    """
    if logdet not in ("exact", "slq"):
        raise ValueError(f"logdet must be 'exact' or 'slq', got {logdet!r}")
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if plan is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        plan = build_sweep_plan(x, levels=levels, rank=rank, name=name,
                                directions=directions,
                                landmark_index=landmark_index,
                                generator=generator, device=dev)
    elif (plan.x_sorted.shape != x.shape or plan.levels != levels
          or plan.rank != rank or plan.metric != KERNEL_METRIC.get(name)):
        raise ValueError("plan does not match x, levels, rank and name")
    noises = [float(v) for v in noises]
    n = x.shape[0]
    y_sorted = y.to(x.dtype)[plan.tree.perm][:, None]
    const = 0.5 * n * math.log(2 * math.pi)
    rows = []
    if logdet == "slq":
        from repro_torch.solvers.slq import rademacher_probes

        probes = slq_probe_vectors
        if probes is None:
            probes = rademacher_probes(
                slq_probes, n, dtype=x.dtype, device=dev,
                generator=slq_generator if slq_generator is not None
                else torch.Generator(device=dev).manual_seed(42))
        probes = torch.as_tensor(probes, dtype=x.dtype, device=dev)
        # one exact inversion per sigma, at the geometric-mean ridge: close
        # enough across the grid that PCG stays a handful of iterations
        ridge0 = math.exp(sum(math.log(v) for v in noises) / len(noises))
        for s in sigmas:
            kernel = BaseKernel(name, sigma=float(s), jitter=jitter)
            factors = sweep_factors(plan, kernel, solve_config)
            quads, lds = slq_row(
                factors, y_sorted, noises, probe_vectors=probes,
                iters=slq_iters, ridge0=ridge0, cg_tol=cg_tol,
                cg_maxiter=cg_maxiter, config=solve_config, sigma=float(s))
            rows.append(0.5 * quads + 0.5 * lds + const)
        return torch.stack(rows)
    for s in sigmas:
        kernel = BaseKernel(name, sigma=float(s), jitter=jitter)
        factors = sweep_factors(plan, kernel, solve_config)
        invs = hmatrix.invert_multi(factors, noises, solve_config)
        quads = torch.stack([
            torch.sum(y_sorted[:, 0] * hmatrix.apply_inverse(
                invs.at(g), y_sorted, solve_config)[:, 0])
            for g in range(len(noises))])
        rows.append(0.5 * quads + 0.5 * invs.logabsdet + const)
    return torch.stack(rows)
