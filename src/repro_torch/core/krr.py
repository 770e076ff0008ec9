"""Fitted HCK kernel ridge model (counterpart of ``repro.core.krr``).

This slice serves a fitted model: ``predict`` computes
f(x) = alpha^T k_hck(X, x) through Algorithm 3 (:mod:`repro_torch.core.oos`)
behind the shape-bucketed :class:`~repro_torch.serving.predict_service.
PredictEngine`.  The fit itself comes with a later slice of the port; a
model fitted by the reference is carried across by
:mod:`repro_torch.convert`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import oos
from repro_torch.core.hck import HCKFactors
from repro_torch.core.kernels_fn import BaseKernel
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
