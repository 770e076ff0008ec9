"""Kernel ridge regression and classification with the HCK kernel
(counterpart of ``repro.core.krr``).

fit:      alpha = (K_hck + lambda I)^-1 y        -- Algorithm 2, O(n r^2)
predict:  f(x)  = alpha^T k_hck(X, x)            -- Algorithm 3
fit_path: alpha_g for a whole grid of lambda_g from one build, scored on
          held-out data in one Algorithm-3 pass  -- the sweep's lambda axis

:func:`fit` pads the data to the tree, builds the factors
(:func:`repro_torch.core.hck.build_hck`), inverts with the leaf factor
kept (:func:`repro_torch.core.hmatrix.invert_with_leaf`), solves with
iterative refinement and prepares the Algorithm-3 plan; on the card every
stage of it runs through a CUDA kernel.  ``predict`` serves the model
behind the shape-bucketed :class:`~repro_torch.serving.predict_service.
PredictEngine`.  A model fitted by the reference is carried across by
:mod:`repro_torch.convert`.

Classification follows the paper: binary as ridge on +-1 labels with a
sign readout, multiclass as one-vs-all ridge over one shared
factorization.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as _device
from repro_torch.core import hmatrix, oos
from repro_torch.core.hck import HCKFactors, build_hck
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import auto_levels_ceil, pad_points
from repro_torch.kernels.registry import SolveConfig

Tensor = torch.Tensor


@dataclasses.dataclass
class HCKRegressor:
    """Fitted HCK kernel ridge model.

    ``squeeze`` records that the fit took 1-D regression targets, so
    ``predict`` returns (q,); otherwise it returns (q, k) scores.
    ``classes`` holds the class labels of a classification fit: binary
    fits have one +-1 score column, multiclass fits one column per class
    (one-vs-all).
    """

    kernel: BaseKernel
    factors: HCKFactors
    plan: oos.OOSPlan          # Algorithm-3 precomputation over alpha
    alpha: Tensor              # (n, k) dual coefficients, tree order
    classes: Tensor | None = None
    squeeze: bool = False
    solve_config: SolveConfig | None = None
    lam: float | None = None            # fit ridge
    base_leaf_size: int | None = None   # leaf size the fit froze at
    inverse: hmatrix.InverseFactors | None = None  # cached Algorithm-2 inverse
    leaf_lo: Tensor | None = None       # its leaf Schur Cholesky factors

    def __post_init__(self):
        self._engine = None

    @property
    def engine(self):
        """Shape-bucketed prediction service over the plan (built lazily)."""
        from repro_torch.serving.predict_service import PredictEngine

        return PredictEngine.attach(self)

    def predict(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q,) when fit with 1-D y, else (q, k) scores."""
        z = self.engine(queries)
        return z[:, 0] if self.squeeze else z

    def predict_class(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q,) predicted class labels (classification fits)."""
        if self.classes is None:
            raise ValueError("model was fit for regression")
        z = self.engine(queries)
        if z.shape[1] == 1:  # binary +-1
            return torch.where(z[:, 0] > 0, self.classes[1], self.classes[0])
        return self.classes[torch.argmax(z, dim=1)]


def _encode_targets(y: Tensor, classification: bool, dtype: torch.dtype):
    """Targets (n, k) in ``dtype``, class labels or None, and the squeeze
    flag of 1-D regression targets."""
    if classification:
        classes = torch.unique(y)
        one = torch.ones((), dtype=dtype, device=y.device)
        if classes.shape[0] == 2:           # +-1 coding, one column
            targets = torch.where(y == classes[1], one, -one)[:, None]
        else:                               # one-vs-all
            targets = torch.where(y[:, None] == classes[None, :], one, -one)
        return targets, classes, False
    return (y if y.ndim > 1 else y[:, None]).to(dtype), None, y.ndim == 1


def _health_probe(stage: str, value, config: SolveConfig | None) -> None:
    """Hook of the reference's runtime health probes (``repro.runtime.
    health``, on only under ``REPRO_STRICT_FINITE`` or ``config.checks``);
    they are not ported yet (ROADMAP item A12), so it does nothing."""
    del stage, value, config


def fit(
    x, y, *, kernel: BaseKernel, lam: float, rank: int,
    leaf_size: int | None = None, levels: int | None = None,
    method: str = "rp", classification: bool = False,
    shared_landmarks: bool = False, solve_config: SolveConfig | None = None,
    landmarks=None, rank_budget: int | None = None, device=None,
    generator: torch.Generator | None = None, pad_index=None,
    pad_noise=None, directions=None, landmark_index=None,
) -> HCKRegressor:
    """Fit KRR with the paper's sizing rule (Eq. 22) unless ``levels`` given.

    x:          (n, d) training points (float32 or float64, tensor or
                array); the factors keep its dtype.
    y:          (n,) or (n, k) targets; classification reads class labels
                from a 1-D ``y``.  Targets are cast to the dtype of x.
    kernel:     base kernel (name, sigma, jitter).
    lam:        ridge of the Algorithm-2 solve.
    rank:       landmarks per node; ``leaf_size`` defaults to it.
    levels:     tree depth; default ``max(1, auto_levels_ceil(n,
                leaf_size))``, with inputs that do not fill the tree padded
                by :func:`repro_torch.core.partition.pad_points`.
    solve_config: stage backends of the build and of the solve, and
                ``refine_steps``; "auto" runs the CUDA kernels on the card.
    device:     where the fit runs; None means the CUDA card (raises
                without one), "cpu" runs the plain versions.
    generator:  source of the padding, partition and landmark draws
                (default: seeded 0 on ``device``).  ``pad_index`` /
                ``pad_noise``, ``directions`` and ``landmark_index``
                replace those draws (see ``pad_points`` and ``build_hck``).

    ``landmarks`` (a landmark policy), ``rank_budget``,
    ``shared_landmarks=True`` and ``method="pca"`` (ROADMAP item A10) and
    a ``solve_config.precision`` (item A15) raise ``NotImplementedError``.
    The model caches the Algorithm-2 inverse and its leaf Cholesky factors.
    """
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n = x.shape[0]
    leaf_size = leaf_size if leaf_size is not None else rank
    if levels is None:
        levels = max(1, auto_levels_ceil(n, leaf_size))
    x, y, _ = pad_points(x, y, leaf_size, levels, generator=generator,
                         index=pad_index, noise=pad_noise)
    targets, classes, squeeze = _encode_targets(y, classification, x.dtype)

    factors = build_hck(
        x, levels=levels, rank=rank, kernel=kernel, method=method,
        shared_landmarks=shared_landmarks, config=solve_config,
        policy=landmarks, rank_budget=rank_budget, directions=directions,
        landmark_index=landmark_index, generator=generator)
    _health_probe("build", factors, solve_config)
    y_sorted = targets[factors.tree.perm]
    inv, lo = hmatrix.invert_with_leaf(factors, lam, solve_config)
    _health_probe("leaf_factor", lo, solve_config)
    alpha = hmatrix.solve_with_inverse(factors, inv, y_sorted, ridge=lam,
                                       config=solve_config)
    _health_probe("solve", alpha, solve_config)
    plan = oos.prepare(factors, alpha, solve_config)
    return HCKRegressor(kernel, factors, plan, alpha, classes,
                        squeeze=squeeze, solve_config=solve_config, lam=lam,
                        base_leaf_size=factors.leaf_size, inverse=inv,
                        leaf_lo=lo)


@dataclasses.dataclass
class KRRPath:
    """A fitted regularization path: one hierarchy, G ridge solutions.

    ``alphas[g]`` are the dual coefficients at ``lams[g]`` (tree order);
    ``scores[g]`` the validation score at that lambda (relative error for
    regression, misclassification rate for classification: lower is
    better in both), or None without a validation set.  :meth:`model`
    materializes the :class:`HCKRegressor` at one grid index; :meth:`best`
    at the score argmin.
    """

    kernel: BaseKernel
    factors: HCKFactors
    lams: Tensor               # (G,)
    alphas: Tensor             # (G, n, k) dual coefficients, tree order
    scores: Tensor | None      # (G,) validation scores, or None
    classes: Tensor | None = None
    squeeze: bool = False
    solve_config: SolveConfig | None = None

    def model(self, g: int) -> HCKRegressor:
        """The fitted model at grid index ``g`` (prepares its Algorithm-3
        plan)."""
        plan = oos.prepare(self.factors, self.alphas[g], self.solve_config)
        return HCKRegressor(self.kernel, self.factors, plan, self.alphas[g],
                            self.classes, squeeze=self.squeeze,
                            solve_config=self.solve_config,
                            lam=float(self.lams[g]),
                            base_leaf_size=self.factors.leaf_size)

    def best(self) -> HCKRegressor:
        """The model at the validation-score argmin (needs scores)."""
        if self.scores is None:
            raise ValueError("fit_path was called without a validation set; "
                             "pick an index and call .model(g)")
        return self.model(int(torch.argmin(self.scores)))


def _path_scores(factors: HCKFactors, alphas: Tensor, x_val: Tensor,
                 y_val: Tensor, kernel: BaseKernel, classes: Tensor | None,
                 config: SolveConfig | None) -> Tensor:
    """Validation score of every lambda from ONE Algorithm-3 pass: the
    prediction is linear in alpha, so the G coefficient sets ride as G * k
    right-hand-side columns of one plan."""
    g_count, n, k = alphas.shape
    alpha_cols = alphas.permute(1, 2, 0).reshape(n, k * g_count)
    plan = oos.prepare(factors, alpha_cols, config)
    z = oos.apply_plan(factors, plan, x_val, kernel, config)
    z = z.reshape(-1, k, g_count)                        # (q, k, G)
    if classes is not None:
        if classes.shape[0] == 2:
            pred = torch.where(z[:, 0, :] > 0, classes[1], classes[0])
        else:
            pred = classes[torch.argmax(z, dim=1)]       # (q, G)
        return (pred != y_val[:, None]).to(torch.float32).mean(dim=0)
    yv = (y_val if y_val.ndim > 1 else y_val[:, None]).to(z.dtype)
    return (torch.linalg.vector_norm(z - yv[:, :, None], dim=(0, 1))
            / torch.linalg.vector_norm(yv))


def fit_path(
    x, y, *, kernel: BaseKernel, lams, rank: int | None = None,
    leaf_size: int | None = None, levels: int | None = None,
    method: str = "rp", classification: bool = False,
    shared_landmarks: bool = False, solve_config: SolveConfig | None = None,
    x_val=None, y_val=None, factors: HCKFactors | None = None,
    landmarks=None, rank_budget: int | None = None, device=None,
    generator: torch.Generator | None = None, pad_index=None,
    pad_noise=None, directions=None, landmark_index=None,
) -> KRRPath:
    """Fit the whole regularization path from one build (the sweep engine's
    lambda axis).

    The factors do not depend on lambda, so where a grid search runs
    :func:`fit` per lambda, this pads, partitions and builds ONCE, stacks
    all G leaf Schur factorizations into one ``leaf_factor`` launch
    (:func:`repro_torch.core.hmatrix.invert_multi`), solves each lambda
    with refinement, and scores every lambda on ``x_val`` / ``y_val``
    (optional) in one Algorithm-3 pass with G * k columns.

    Parameters are those of :func:`fit` with ``lams`` a sequence of ridges.
    ``factors`` supplies a prebuilt hierarchy (e.g. one sigma of
    :func:`repro_torch.core.hck.sweep_factors`); ``x`` and ``y`` must then
    already have its padded size and the build options (``rank``,
    ``leaf_size``, ``levels``, the draws) are not read.  On the card
    (``device`` None) every stage is a CUDA kernel.
    """
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if factors is None:
        if rank is None:
            raise ValueError("rank is required when no prebuilt factors "
                             "are given")
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        leaf_size = leaf_size if leaf_size is not None else rank
        if levels is None:
            levels = max(1, auto_levels_ceil(x.shape[0], leaf_size))
        x, y, _ = pad_points(x, y, leaf_size, levels, generator=generator,
                             index=pad_index, noise=pad_noise)
        factors = build_hck(
            x, levels=levels, rank=rank, kernel=kernel, method=method,
            shared_landmarks=shared_landmarks, config=solve_config,
            policy=landmarks, rank_budget=rank_budget, directions=directions,
            landmark_index=landmark_index, generator=generator)
    elif x.shape[0] != factors.n or y.shape[0] != factors.n:
        raise ValueError(
            f"prebuilt factors cover n={factors.n} points but x has "
            f"{x.shape[0]} and y has {y.shape[0]} rows; pad x and y to the "
            "factor tree first")
    targets, classes, squeeze = _encode_targets(y, classification, x.dtype)
    y_sorted = targets[factors.tree.perm]
    lam_list = [float(lam) for lam in lams]
    invs = hmatrix.invert_multi(factors, lam_list, solve_config)
    alphas = torch.stack([
        hmatrix.solve_with_inverse(factors, invs.at(g), y_sorted, ridge=lam,
                                   config=solve_config)
        for g, lam in enumerate(lam_list)])                  # (G, n, k)
    scores = None
    if x_val is not None:
        if y_val is None:
            raise ValueError("x_val given without y_val")
        scores = _path_scores(factors, alphas, torch.as_tensor(x_val).to(dev),
                              torch.as_tensor(y_val).to(dev), kernel,
                              classes, solve_config)
    return KRRPath(kernel, factors,
                   torch.tensor(lam_list, dtype=x.dtype, device=dev), alphas,
                   scores, classes, squeeze=squeeze,
                   solve_config=solve_config)
