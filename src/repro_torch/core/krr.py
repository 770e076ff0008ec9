"""Kernel ridge regression and classification with the HCK kernel
(counterpart of ``repro.core.krr``).

fit:      alpha = (K_hck + lambda I)^-1 y        -- Algorithm 2, O(n r^2)
fit_streaming: the same model from a host-resident ChunkSource, the
          points staged through the device in chunks and leaf groups
predict:  f(x)  = alpha^T k_hck(X, x)            -- Algorithm 3
fit_path: alpha_g for a whole grid of lambda_g from one build, scored on
          held-out data in one Algorithm-3 pass  -- the sweep's lambda axis
fit_exact: EXACT-kernel KRR by CG on the matvec-free exact-kernel
          operator, preconditioned by the HCK structured inverse
fit_incremental / HCKRegressor.update: absorb new points into a fitted
          model on its frozen hierarchy, without the rebuild

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
from repro_torch.core.hck import HCKFactors, build_hck, build_hck_streaming
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.partition import (auto_levels, auto_levels_ceil,
                                        pad_points)
from repro_torch.data.pipeline import pad_source, torch_dtype
from repro_torch.kernels.registry import SolveConfig
from repro_torch.precision import entry_point
from repro_torch.runtime import health

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
        self._leaf_linv = None

    @property
    def leaf_linv(self) -> Tensor:
        """Leaf-granularity inverse Cholesky factors (P, r, r) of the last
        level's Sigma.  The landmark factors are frozen across online
        inserts, so this is computed once, on first use, and handed to
        every :func:`repro_torch.core.update.insert`."""
        if self._leaf_linv is None:
            from repro_torch.core.hck import sigma_linv

            self._leaf_linv = torch.repeat_interleave(
                sigma_linv(self.factors.sigma_cho[-1]), 2, dim=0)
        return self._leaf_linv

    @property
    def engine(self):
        """Shape-bucketed prediction service over the plan (built lazily)."""
        from repro_torch.serving.predict_service import PredictEngine

        return PredictEngine.attach(self)

    @entry_point
    def predict(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q,) when fit with 1-D y, else (q, k) scores."""
        z = self.engine(queries)
        return z[:, 0] if self.squeeze else z

    @entry_point
    def predict_class(self, queries: Tensor) -> Tensor:
        """(q, d) -> (q,) predicted class labels (classification fits)."""
        if self.classes is None:
            raise ValueError("model was fit for regression")
        z = self.engine(queries)
        if z.shape[1] == 1:  # binary +-1
            return torch.where(z[:, 0] > 0, self.classes[1], self.classes[0])
        return self.classes[torch.argmax(z, dim=1)]

    def update(self, x_new, y_new, **kwargs):
        """Absorb new points online: ``fit_incremental(self, ...)``.
        Returns ``(model, info)``; the model is a NEW instance and this one
        stays servable."""
        return fit_incremental(self, x_new, y_new, **kwargs)


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


@entry_point
def fit(
    x, y, *, kernel: BaseKernel, lam: float, rank: int,
    leaf_size: int | None = None, levels: int | None = None,
    method: str = "rp", classification: bool = False,
    shared_landmarks: bool = False, solve_config: SolveConfig | None = None,
    landmarks=None, rank_budget: int | None = None, device=None,
    generator: torch.Generator | None = None, pad_index=None,
    pad_noise=None, directions=None, landmark_index=None, policy_draws=None,
    timings: dict | None = None,
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
                ``checks`` (or ``REPRO_STRICT_FINITE``) probes the
                factors, the leaf factor and alpha
                (:mod:`repro_torch.runtime.health`).
    device:     where the fit runs; None means the CUDA card (raises
                without one), "cpu" runs the plain versions.
    generator:  source of the padding, partition and landmark draws
                (default: seeded 0 on ``device``).  ``pad_index`` /
                ``pad_noise``, ``directions`` and ``landmark_index``
                replace those draws (see ``pad_points`` and ``build_hck``).

    landmarks:  landmark policy, None / "uniform", "kmeans", "leverage" or
                a :class:`~repro_torch.landmarks.policy.LandmarkPolicy`;
                ``policy_draws`` (one dict per level) replaces its draws.
    rank_budget: global cap on the sum of the per-node ranks (see
                :func:`repro_torch.core.hck.build_hck`).
    method:     partition rule, "rp" or "pca"; ``shared_landmarks`` puts
                the root's landmarks at every node.

    ``solve_config.precision`` is the mixed-precision policy of the build
    and of the predictions (:func:`repro_torch.kernels.registry.
    precision_policy`): the factors, the solve and alpha are in its factor
    dtype, the tree and the landmarks in the dtype of x.  The model keeps
    its ``solve_config``, so its predictions and updates follow the
    policy.  The model caches the Algorithm-2 inverse and
    its leaf Cholesky factors, which :meth:`HCKRegressor.update` extends.
    ``timings``, a dict, receives the wall seconds of ``build_hck`` and
    of the stages after it (the device synchronised).
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

    factors = _device.timed(timings, "build_hck", dev, lambda: build_hck(
        x, levels=levels, rank=rank, kernel=kernel, method=method,
        shared_landmarks=shared_landmarks, config=solve_config,
        policy=landmarks, rank_budget=rank_budget, directions=directions,
        landmark_index=landmark_index, policy_draws=policy_draws,
        generator=generator))
    return _solve_built(factors, targets, classes, squeeze, kernel, lam,
                        solve_config, timings)


def _solve_built(factors: HCKFactors, targets: Tensor, classes, squeeze,
                 kernel: BaseKernel, lam: float,
                 solve_config: SolveConfig | None,
                 timings: dict | None = None) -> HCKRegressor:
    """The fit after the build: probe the factors, invert with the leaf
    factor kept, solve, probe alpha and prepare the Algorithm-3 plan.
    ``timings``, a dict, receives the wall seconds of the last three
    stages (the device synchronised).  The targets are solved in the
    factors' dtype (a mixed-precision policy's factor dtype)."""
    def stage(name, fn):
        return _device.timed(timings, name, targets.device, fn)

    health.probe_factors(factors, solve_config, op="build")
    y_sorted = targets[factors.tree.perm].to(factors.adiag.dtype)
    inv, lo = stage("invert_with_leaf", lambda: hmatrix.invert_with_leaf(
        factors, lam, solve_config))
    health.probe_leaf_factor(lo, solve_config)
    alpha = stage("solve_with_inverse", lambda: hmatrix.solve_with_inverse(
        factors, inv, y_sorted, ridge=lam, config=solve_config))
    health.check_finite("solve", alpha, config=solve_config,
                        detail="dual coefficients (fit)")
    plan = stage("prepare", lambda: oos.prepare(factors, alpha,
                                                solve_config))
    return HCKRegressor(kernel, factors, plan, alpha, classes,
                        squeeze=squeeze, solve_config=solve_config, lam=lam,
                        base_leaf_size=factors.leaf_size, inverse=inv,
                        leaf_lo=lo)


@entry_point
def fit_streaming(
    source, y, *, kernel: BaseKernel, lam: float, rank: int,
    leaf_size: int | None = None, levels: int | None = None,
    classification: bool = False, solve_config: SolveConfig | None = None,
    leaf_batch: int = 64, chunk_rows: int = 1 << 16, landmarks=None,
    rank_budget: int | None = None, device=None,
    generator: torch.Generator | None = None, pad_index=None,
    pad_noise=None, directions=None, landmark_index=None,
    timings: dict | None = None,
) -> HCKRegressor:
    """Fit KRR from a host-resident :class:`repro_torch.data.pipeline.
    ChunkSource`.

    The model of :func:`fit`, but the raw points are never on the device
    in one piece: the partition streams chunks of ``chunk_rows`` rows and
    the leaf stages take ``leaf_batch`` leaves a launch
    (:func:`repro_torch.core.hck.build_hck_streaming`).  Inputs that do
    not fill the tree are padded on the host with :func:`fit`'s
    duplicate-and-jitter rows (:func:`repro_torch.data.pipeline.
    pad_source`).  The model caches the Algorithm-2 inverse and its leaf
    factor, with :func:`fit`'s probes, so :meth:`HCKRegressor.update`
    works on it.

    ``y`` (n,) or (n, k) goes to the device (targets are O(n k)).
    ``device`` (None = the card) and ``generator`` (default seeded 0 on
    ``device``) as in :func:`fit`: with the same generator the pad rows,
    the tree and the landmarks are :func:`fit`'s on the same points;
    ``pad_index`` / ``pad_noise``, ``directions`` and ``landmark_index``
    replace those draws.  ``landmarks`` must be the uniform policy and
    ``rank_budget`` None (``ValueError`` otherwise).  ``timings``, a
    dict, receives the wall seconds of the stages (the device
    synchronised).
    """
    dev = _device.resolve(device)
    y = torch.as_tensor(y).to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    leaf_size = leaf_size if leaf_size is not None else rank
    if levels is None:
        levels = max(1, auto_levels_ceil(source.n, leaf_size))
    source, y, _ = pad_source(source, y, leaf_size, levels,
                              generator=generator, index=pad_index,
                              noise=pad_noise)
    targets, classes, squeeze = _encode_targets(y, classification,
                                                torch_dtype(source))
    factors = build_hck_streaming(
        source, levels=levels, rank=rank, kernel=kernel, config=solve_config,
        leaf_batch=leaf_batch, chunk_rows=chunk_rows, policy=landmarks,
        rank_budget=rank_budget, directions=directions,
        landmark_index=landmark_index, generator=generator, device=dev,
        timings=timings)
    return _solve_built(factors, targets, classes, squeeze, kernel, lam,
                        solve_config, timings)


@dataclasses.dataclass
class UpdateInfo:
    """Diagnostics of one :func:`fit_incremental` round.

    ``iterations`` / ``residual`` / ``converged`` describe the re-solve
    (warm-started CG for ``refresh="stale"``; 0 iterations for the
    structured solves of "inverse" and "exact").  ``cold_iterations`` is
    the count of CG without carried state, with ``measure_cold=True``.
    ``needs_rebuild`` is the :class:`repro_torch.core.update.RebuildPolicy`
    verdict: True means schedule a full :func:`fit`.
    """

    record: object             # repro_torch.core.update.InsertRecord
    refresh: str
    iterations: int
    residual: float
    converged: bool
    cold_iterations: int | None = None
    needs_rebuild: bool = False


def _encode_arrivals(model: HCKRegressor, y_new: Tensor,
                     dtype: torch.dtype) -> Tensor:
    """Targets (q, k) of new points in the model's fit-time encoding;
    labels outside a classifier's classes raise."""
    if model.classes is None:
        return (y_new if y_new.ndim > 1 else y_new[:, None]).to(dtype)
    if not bool(torch.isin(y_new, model.classes).all()):
        raise ValueError("y_new contains labels outside the fitted classes; "
                         "a full refit is required")
    one = torch.ones((), dtype=dtype, device=y_new.device)
    if model.classes.shape[0] == 2:
        return torch.where(y_new == model.classes[1], one, -one)[:, None]
    return torch.where(y_new[:, None] == model.classes[None, :], one, -one)


def _stale_preconditioner(f_new: HCKFactors, inv_base, n0_old: int,
                          lam: float, config: SolveConfig | None):
    """The stale structured inverse lifted to the grown leaves.

    ``P = [I  -A^-1 B^T; 0  I] blkdiag(A^-1, S~^-1) [I  0; -B A^-1  I]``,
    with A^-1 the UNREFRESHED inverse of the old rows, B the exact
    coupling of old and appended rows (read off two Algorithm-1 matvecs,
    no block materialized) and S~ the leaf-local Schur complement of the
    appended rows: SPD by congruence, exact up to the inter-leaf coupling
    that S~ drops.
    """
    p_leaves, n0_new = f_new.num_leaves, f_new.leaf_size
    bb, cc = hmatrix.extension_blocks(f_new, n0_base=n0_old, ridge=lam)
    l21 = bb @ inv_base.linv.mT
    s_inv = torch.linalg.inv_ex(cc - l21 @ l21.mT)[0]

    def split(v):
        vb = v.reshape(p_leaves, n0_new, -1)
        return vb[:, :n0_old], vb[:, n0_old:]

    def join(v_old, v_app):
        return torch.cat([v_old, v_app], dim=1).reshape(
            -1, v_old.shape[-1])

    def op(v):
        return hmatrix.matvec(f_new, v, config) + lam * v

    def precond(r):
        ncols = r.shape[-1] if r.ndim > 1 else 1
        r_old, r_app = split(r)
        z1 = hmatrix.apply_inverse(inv_base, r_old.reshape(-1, ncols),
                                   config).reshape(p_leaves, n0_old, ncols)
        _, bz1 = split(op(join(z1, torch.zeros_like(r_app))))
        z_app = s_inv @ (r_app - bz1)
        btz, _ = split(op(join(torch.zeros_like(z1), z_app)))
        z_old = z1 - hmatrix.apply_inverse(
            inv_base, btz.reshape(-1, ncols), config).reshape(
                p_leaves, n0_old, ncols)
        return join(z_old, z_app).reshape(r.shape)

    return precond


@entry_point
def fit_incremental(
    model: HCKRegressor, x_new, y_new, *, refresh: str = "inverse",
    policy=None, generator: torch.Generator | None = None, pad_index=None,
    pad_noise=None, tol: float = 1e-8, maxiter: int = 200,
    measure_cold: bool = False,
) -> tuple[HCKRegressor, UpdateInfo]:
    """Absorb a batch of new points into a fitted model without rebuilding.

    The arrivals are routed down the FROZEN tree and appended to their
    leaves (:func:`repro_torch.core.update.insert`: landmarks, Sigma, W,
    the rank masks and the fit-time lambda' diagonal untouched), then the
    dual coefficients are solved again on the union:

    ``refresh="inverse"`` (default): the cached leaf Schur Cholesky pair
      is extended by the bordered ``leaf_update`` stage
      (:func:`repro_torch.core.hmatrix.invert_extend`, B13 on the card)
      and the refreshed structured inverse solves as in :func:`fit`; it
      matches a from-scratch :func:`repro_torch.core.update.refit_frozen`
      to round-off.
    ``refresh="exact"``: the cached pair is not reused; the grown
      hierarchy is inverted from scratch (:func:`hmatrix.invert_with_leaf`,
      B3 at the grown leaf size).
    ``refresh="stale"``: no refactorization; CG on the grown operator,
      warm-started from the old alpha (zeros on the appended rows) and
      preconditioned by the stale inverse lifted to the appended rows.

    The fit-time targets are reconstructed from the model itself, ``y =
    (K_hck + lam) alpha``.  ``y_new`` takes the fit's encoding (regression
    columns, or labels of ``model.classes``; new labels raise).
    ``generator`` (default seeded with n on the model's device) draws the
    padding rows, which ``pad_index`` (P, k) and ``pad_noise`` (P, k, d)
    replace.  ``policy`` is a :class:`~repro_torch.core.update.
    RebuildPolicy`.  Returns ``(model_new, info)``; the input model is
    untouched.
    """
    from repro_torch.core.update import RebuildPolicy, insert
    from repro_torch.solvers.cg import pcg

    if refresh not in ("inverse", "exact", "stale"):
        raise ValueError(f"unknown refresh {refresh!r}; use 'inverse', "
                         "'exact' or 'stale'")
    if model.lam is None:
        raise ValueError("model carries no fit ridge (built before the "
                         "online-update engine?): refit with krr.fit")
    f, lam, cfg = model.factors, model.lam, model.solve_config
    dev, dt = f.x_sorted.device, f.x_sorted.dtype
    base = model.base_leaf_size or f.leaf_size
    policy = policy if policy is not None else RebuildPolicy()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(f.n)
    x_new = torch.as_tensor(x_new).to(device=dev, dtype=dt)
    targets_new = _encode_arrivals(model, torch.as_tensor(y_new).to(dev),
                                   f.adiag.dtype)

    # the fit-time targets, reconstructed: y_sorted = (K_hck + lam) alpha
    y_sorted = hmatrix.matvec(f, model.alpha, cfg) + lam * model.alpha
    f_new, y_sorted_new, rec = insert(
        f, x_new, model.kernel, config=cfg, y_new=targets_new,
        y_sorted=y_sorted, jitter_rows=base, linv_leaf=model.leaf_linv,
        pad_index=pad_index, pad_noise=pad_noise, generator=generator)
    if rec.k == 0:                      # an empty batch: exact no-op
        return model, UpdateInfo(rec, refresh, 0, 0.0, True)
    health.probe_factors(f_new, cfg, op="update.insert")

    n0_old = f.leaf_size
    inv_base, lo_base = model.inverse, model.leaf_lo
    if inv_base is None or lo_base is None or inv_base.leaf_size != n0_old:
        inv_base, lo_base = hmatrix.invert_with_leaf(f, lam, cfg)

    cold_iters = None
    iters = 0
    if refresh == "inverse":
        inv_new, lo_new = hmatrix.invert_extend(
            f_new, lo_base, inv_base.linv, n0_base=n0_old, ridge=lam,
            config=cfg)
        health.probe_leaf_factor(lo_new, cfg, stage="leaf_update")
        alpha_new = hmatrix.solve_with_inverse(
            f_new, inv_new, y_sorted_new, ridge=lam, config=cfg)
    elif refresh == "exact":
        inv_new, lo_new = hmatrix.invert_with_leaf(f_new, lam, cfg)
        health.probe_leaf_factor(lo_new, cfg)
        alpha_new = hmatrix.solve_with_inverse(
            f_new, inv_new, y_sorted_new, ridge=lam, config=cfg)
    else:
        p_leaves, n0_new = f_new.num_leaves, f_new.leaf_size
        kcols = model.alpha.shape[1]
        precond = _stale_preconditioner(f_new, inv_base, n0_old, lam, cfg)
        x0 = model.alpha.new_zeros((p_leaves, n0_new, kcols))
        x0[:, :n0_old] = model.alpha.reshape(p_leaves, n0_old, kcols)

        def amv(v):
            return hmatrix.matvec(f_new, v, cfg)

        res = pcg(amv, y_sorted_new, ridge=lam, precond=precond,
                  x0=x0.reshape(-1, kcols), tol=tol, maxiter=maxiter)
        health.probe_cg(res, tol=tol, config=cfg, context="refresh=stale")
        alpha_new, iters = res.x, int(res.iterations)
        if measure_cold:
            # no carried state at all: neither the stale inverse nor alpha
            cold_iters = int(pcg(amv, y_sorted_new, ridge=lam, tol=tol,
                                 maxiter=maxiter).iterations)
        inv_new, lo_new = inv_base, lo_base   # kept stale for the next lift

    health.check_finite("solve", alpha_new, config=cfg,
                        detail=f"dual coefficients (refresh={refresh})")
    resid = y_sorted_new - (hmatrix.matvec(f_new, alpha_new, cfg)
                            + lam * alpha_new)
    rel = float(torch.linalg.vector_norm(resid)
                / torch.linalg.vector_norm(y_sorted_new))
    plan = oos.prepare(f_new, alpha_new, cfg)
    model_new = HCKRegressor(
        model.kernel, f_new, plan, alpha_new, model.classes,
        squeeze=model.squeeze, solve_config=cfg, lam=lam,
        base_leaf_size=base, inverse=inv_new, leaf_lo=lo_new)
    model_new._leaf_linv = model._leaf_linv   # frozen landmarks: carried
    needs_rebuild = policy.should_rebuild(
        base_leaf_size=base, leaf_size=f_new.leaf_size,
        warm_iters=iters if refresh == "stale" else None, update_error=rel)
    info = UpdateInfo(rec, refresh, iters, rel,
                      converged=(rel <= max(tol, 1e-6)
                                 or refresh in ("inverse", "exact")),
                      cold_iterations=cold_iters, needs_rebuild=needs_rebuild)
    return model_new, info


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


@entry_point
def fit_path(
    x, y, *, kernel: BaseKernel, lams, rank: int | None = None,
    leaf_size: int | None = None, levels: int | None = None,
    method: str = "rp", classification: bool = False,
    shared_landmarks: bool = False, solve_config: SolveConfig | None = None,
    x_val=None, y_val=None, factors: HCKFactors | None = None,
    landmarks=None, rank_budget: int | None = None, device=None,
    generator: torch.Generator | None = None, pad_index=None,
    pad_noise=None, directions=None, landmark_index=None, policy_draws=None,
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
            landmark_index=landmark_index, policy_draws=policy_draws,
            generator=generator)
    elif x.shape[0] != factors.n or y.shape[0] != factors.n:
        raise ValueError(
            f"prebuilt factors cover n={factors.n} points but x has "
            f"{x.shape[0]} and y has {y.shape[0]} rows; pad x and y to the "
            "factor tree first")
    targets, classes, squeeze = _encode_targets(y, classification,
                                                factors.adiag.dtype)
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


@dataclasses.dataclass
class ExactKRR:
    """Exact-kernel KRR model trained by a matvec-free iterative solver.

    Its dual coefficients solve ``(K(X, X) + lam I) alpha = y`` for the
    exact base kernel, and ``predict`` applies the exact cross kernel
    (the ``kernel_matvec`` stage, a CUDA kernel on the card), unlike
    :class:`HCKRegressor`, whose predictions go through the Algorithm-3
    plan of the approximate kernel.  ``alpha`` is in the ORIGINAL row
    order of ``x`` (the hierarchy acts only as a preconditioner).
    ``result`` is the solver's :class:`repro_torch.solvers.cg.CGResult`
    (None for a model carried across by :mod:`repro_torch.convert`).
    """

    kernel: BaseKernel
    x: Tensor                  # (n, d) training points, original order
    alpha: Tensor              # (n, k) dual coefficients, original order
    lam: float
    result: object             # repro_torch.solvers.cg.CGResult
    classes: Tensor | None = None
    squeeze: bool = False
    solve_config: SolveConfig | None = None
    row_chunk: int = 1024

    def _op(self):
        from repro_torch.solvers.operators import ExactKernelOp

        return ExactKernelOp(self.x, self.kernel, self.solve_config,
                             row_chunk=self.row_chunk)

    @entry_point
    def predict(self, queries) -> Tensor:
        """(q, d) -> (q,) when fit with 1-D y, else (q, k) scores."""
        queries = torch.as_tensor(queries, device=self.x.device)
        z = self._op().cross_matvec(queries, self.alpha)
        return z[:, 0] if self.squeeze else z

    @entry_point
    def predict_class(self, queries) -> Tensor:
        """(q, d) -> (q,) predicted class labels (classification fits)."""
        if self.classes is None:
            raise ValueError("model was fit for regression")
        queries = torch.as_tensor(queries, device=self.x.device)
        z = self._op().cross_matvec(queries, self.alpha)
        if z.shape[1] == 1:  # binary +-1
            return torch.where(z[:, 0] > 0, self.classes[1], self.classes[0])
        return self.classes[torch.argmax(z, dim=1)]


def _hck_preconditioner(x: Tensor, *, kernel: BaseKernel, lam: float,
                        rank: int, leaf_size: int | None, levels: int | None,
                        method: str, solve_config: SolveConfig | None,
                        generator: torch.Generator, pad_index=None,
                        pad_noise=None, directions=None, landmark_index=None):
    """The Algorithm-2 structured inverse as a CG preconditioner.

    The hierarchy is built on a PADDED copy of ``x`` (padding repeats
    existing rows, plus 1e-4 noise) and applied through the weighted
    embed and extract ``P = A^T M A``, ``A = E D^-1/2``, with E the
    duplication map and D its column multiplicities: up to the pad noise,
    ``P = (D^1/2 K_hck D^1/2 + lam)^-1``, SPD and spectrally within max
    m_i (~2) of (K_hck + lam)^-1; how much it speeds CG up rests on how
    well K_hck approximates K (at covtype width, d = 54, it does not:
    ROADMAP item C6).  The extract sums duplicate rows with
    ``index_add_``.  Without ``levels`` the tree takes the FLOOR depth and
    a ceil leaf size, which pads less than one row per leaf (never below
    ``rank``).  ``pad_index`` / ``pad_noise``, ``directions`` and
    ``landmark_index`` replace the draws from ``generator``.  Returns
    ``(precond, factors, inv)``.
    """
    n = x.shape[0]
    leaf_size = leaf_size if leaf_size is not None else rank
    if levels is None:
        levels = max(1, auto_levels(n, leaf_size))
        leaf_size = max(-(-n // (1 << levels)), leaf_size)
    target = leaf_size * (1 << levels)
    if n > target:
        raise ValueError(
            f"n={n} exceeds the preconditioner tree capacity {target} "
            f"(leaf_size={leaf_size} x 2**{levels}); raise levels or "
            "leaf_size, or leave them None for automatic sizing")
    src = torch.arange(n, device=x.device)
    if n == target:
        x_pad, row_w = x, torch.ones((n,), dtype=x.dtype, device=x.device)
    else:
        # pad_points' own draw, made here so that the duplicates' sources
        # are known for the weighted embed
        if pad_index is None:
            pad_index = torch.randint(0, n, (target - n,), device=x.device,
                                      generator=generator)
        pad_index = torch.as_tensor(pad_index, device=x.device)
        x_pad, _, _ = pad_points(x, None, leaf_size, levels,
                                 generator=generator, index=pad_index,
                                 noise=pad_noise)
        src = torch.cat([src, pad_index.to(torch.int64)])
        mult = torch.zeros((n,), dtype=x.dtype, device=x.device).index_add_(
            0, src, torch.ones((target,), dtype=x.dtype, device=x.device))
        row_w = torch.rsqrt(mult)[src]                 # D^-1/2 per row
    factors = build_hck(x_pad, levels=levels, rank=rank, kernel=kernel,
                        method=method, config=solve_config,
                        directions=directions, landmark_index=landmark_index,
                        generator=generator)
    inv = hmatrix.invert(factors, ridge=lam, config=solve_config)
    perm = factors.tree.perm
    pos = torch.argsort(perm)          # tree position of each padded row

    def precond(r: Tensor) -> Tensor:
        rp = (r[src] * row_w[:, None])[perm]
        z = hmatrix.apply_inverse(inv, rp.contiguous(), solve_config)[pos]
        return torch.zeros_like(r).index_add_(0, src, z * row_w[:, None])

    return precond, factors, inv


@entry_point
def fit_exact(
    x, y, *, kernel: BaseKernel, lam: float, rank: int = 64,
    leaf_size: int | None = None, levels: int | None = None,
    method: str = "rp", solver: str = "cg", precondition: bool = True,
    tol: float = 1e-6, maxiter: int = 300, classification: bool = False,
    solve_config: SolveConfig | None = None, row_chunk: int = 1024,
    eigenpro_components: int = 160, eigenpro_subsample: int = 2048,
    device=None, generator: torch.Generator | None = None, pad_index=None,
    pad_noise=None, directions=None, landmark_index=None,
    eigenpro_permutation=None,
) -> ExactKRR:
    """Train EXACT-kernel KRR without ever forming K(X, X).

    CG runs on the exact-kernel operator (:class:`repro_torch.solvers.
    operators.ExactKernelOp`; on the card one ``kernel_matvec`` launch per
    iteration), preconditioned by the HCK structured inverse: the paper's
    factorization used as a strictly-PD spectral surrogate of K.  The
    result matches a dense ``torch.linalg.solve(kernel.gram(x) + lam I,
    y)`` to solver tolerance.

    x, y:       training data as in :func:`fit` (classification reads
                class labels from a 1-D ``y``); targets take the dtype of x.
    kernel:     base kernel; ``kernel.gram``'s jitter * n diagonal is part
                of the operator.
    lam:        ridge of the exact solve.
    rank, leaf_size, levels, method:
                sizing of the PRECONDITIONER hierarchy; read only by
                ``solver="cg"`` with ``precondition=True``.  ``levels``
                None takes the floor depth (see :func:`_hck_preconditioner`).
    solver:     "cg" (HCK-preconditioned CG, default) or "eigenpro"
                (:mod:`repro_torch.solvers.eigenpro`, sized by
                ``eigenpro_*``).
    precondition: False runs plain CG, the baseline of the iteration
                count.
    tol, maxiter: relative-residual target and iteration cap.  In float32
                the residual carries eps32 ||K|| of evaluation noise, so a
                tol below that runs to ``maxiter``.
    solve_config: backends of the ``kernel_matvec`` stage and of the
                preconditioner's build and apply.
    row_chunk:  rows per kernel tile of the plain version (its memory
                knob); the card's kernel needs none.
    device:     None is the CUDA card (raises without one), "cpu" the
                plain path.
    generator:  source of the preconditioner's padding, tree and landmark
                draws and of EigenPro's subsample (default seeded 0 on
                ``device``); ``pad_index`` / ``pad_noise``, ``directions``,
                ``landmark_index`` and ``eigenpro_permutation`` replace
                them.
    """
    from repro_torch.solvers.cg import pcg
    from repro_torch.solvers.eigenpro import eigenpro_solve
    from repro_torch.solvers.operators import ExactKernelOp

    if solver not in ("cg", "eigenpro"):
        raise ValueError(f"unknown solver {solver!r}; use 'cg' or 'eigenpro'")
    dev = _device.resolve(device)
    x = torch.as_tensor(x).to(dev)
    y = torch.as_tensor(y).to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    targets, classes, squeeze = _encode_targets(y, classification, x.dtype)
    op = ExactKernelOp(x, kernel, solve_config, row_chunk=row_chunk)
    if solver == "eigenpro":
        res = eigenpro_solve(op, targets, ridge=lam, generator=generator,
                             permutation=eigenpro_permutation,
                             n_components=eigenpro_components,
                             subsample=eigenpro_subsample, tol=tol,
                             maxiter=maxiter)
    else:
        precond = None
        if precondition:
            precond, _, _ = _hck_preconditioner(
                x, kernel=kernel, lam=lam, rank=rank, leaf_size=leaf_size,
                levels=levels, method=method, solve_config=solve_config,
                generator=generator, pad_index=pad_index,
                pad_noise=pad_noise, directions=directions,
                landmark_index=landmark_index)
        res = pcg(op.matvec, targets, ridge=lam, precond=precond, tol=tol,
                  maxiter=maxiter)
    return ExactKRR(kernel, x, res.x, lam, res, classes, squeeze=squeeze,
                    solve_config=solve_config, row_chunk=row_chunk)


def relative_error(pred: Tensor, truth: Tensor) -> Tensor:
    """The paper's regression metric: ||pred - y|| / ||y||."""
    return torch.linalg.vector_norm(pred - truth) / torch.linalg.vector_norm(
        truth)


def accuracy(pred: Tensor, truth: Tensor) -> Tensor:
    """Fraction of exact label matches (the classification metric)."""
    return torch.mean((pred == truth).to(torch.float32))
