"""Carry a model fitted by the JAX reference across to the port.

The input is a flat ``dict[str, numpy.ndarray]`` keyed by the reference's
field paths; a tuple field is spread over ``<field>/<position>`` keys:

  factors  ``x_sorted``, ``perm``, ``directions/<l>``, ``thresholds/<l>``,
           ``landmarks/<l>``, ``sigma/<l>``, ``sigma_cho/<l>`` (l = 0..L-1),
           ``w/<i>`` (i = 0..L-2, the tree levels 1..L-1), ``u``, ``adiag``
  plan     ``plan.c/<i>`` (i = 0..L-1), ``plan.w_leaf``, ``plan.c_tilde``
  model    ``alpha`` and, for a classification fit, ``classes``
  inverse  optional, the cached Algorithm-2 inverse of a fit:
           ``inverse.adiag``, ``inverse.u``, ``inverse.sigma/<l>``,
           ``inverse.w/<i>``, ``inverse.logabsdet``, ``inverse.linv`` and
           ``leaf_lo``

Arrays keep their dtype; indices become int64.  Budgeted-rank factors
(``rank_mask/<l>``) are not served by this slice and are refused.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.hck import HCKFactors
from repro_torch.core.hmatrix import InverseFactors
from repro_torch.core.kernels_fn import BaseKernel
from repro_torch.core.krr import HCKRegressor
from repro_torch.core.oos import OOSPlan
from repro_torch.core.partition import PartitionTree
from repro_torch.kernels.registry import SolveConfig


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    a = np.array(a, dtype=np.int64 if a.dtype.kind in "iu" else a.dtype,
                 order="C")                       # a writable copy
    return torch.from_numpy(a).to(dev)


def _stack(arrays: dict, field: str, count: int, dev) -> tuple:
    try:
        return tuple(_tensor(arrays[f"{field}/{i}"], dev) for i in range(count))
    except KeyError as e:
        raise KeyError(f"model arrays lack {e.args[0]!r}") from None


def _levels(arrays: dict) -> int:
    levels = 0
    while f"directions/{levels}" in arrays:
        levels += 1
    return levels


def factors_from_arrays(arrays: dict, device=None) -> HCKFactors:
    """The port's :class:`HCKFactors` from the reference's arrays."""
    if any(key.startswith("rank_mask/") for key in arrays):
        raise ValueError("budgeted-rank factors (rank_mask) are not served "
                         "by this port yet")
    dev = _device.resolve(device)
    levels = _levels(arrays)
    tree = PartitionTree(_tensor(arrays["perm"], dev),
                         _stack(arrays, "directions", levels, dev),
                         _stack(arrays, "thresholds", levels, dev))
    return HCKFactors(
        x_sorted=_tensor(arrays["x_sorted"], dev), tree=tree,
        landmarks=_stack(arrays, "landmarks", levels, dev),
        sigma=_stack(arrays, "sigma", levels, dev),
        sigma_cho=_stack(arrays, "sigma_cho", levels, dev),
        w=_stack(arrays, "w", max(levels - 1, 0), dev),
        u=_tensor(arrays["u"], dev), adiag=_tensor(arrays["adiag"], dev))


def plan_from_arrays(arrays: dict, device=None) -> OOSPlan:
    """The port's :class:`OOSPlan` from the reference's ``plan.*`` arrays."""
    dev = _device.resolve(device)
    levels = _levels(arrays)
    c_tilde = arrays.get("plan.c_tilde")
    return OOSPlan(_stack(arrays, "plan.c", levels, dev),
                   _tensor(arrays["plan.w_leaf"], dev),
                   None if c_tilde is None else _tensor(c_tilde, dev))


def inverse_from_arrays(arrays: dict, device=None) -> InverseFactors | None:
    """The port's :class:`InverseFactors` from the reference's
    ``inverse.*`` arrays, or None when the arrays carry no inverse."""
    if "inverse.adiag" not in arrays:
        return None
    dev = _device.resolve(device)
    levels = _levels(arrays)
    linv = arrays.get("inverse.linv")
    return InverseFactors(
        _tensor(arrays["inverse.adiag"], dev), _tensor(arrays["inverse.u"], dev),
        _stack(arrays, "inverse.sigma", levels, dev),
        _stack(arrays, "inverse.w", max(levels - 1, 0), dev),
        _tensor(arrays["inverse.logabsdet"], dev),
        None if linv is None else _tensor(linv, dev))


def regressor_from_arrays(arrays: dict, *, kernel: str, sigma: float,
                          jitter: float, squeeze: bool = False,
                          solve_config: SolveConfig | None = None,
                          lam: float | None = None,
                          device=None) -> HCKRegressor:
    """The port's :class:`HCKRegressor` on ``device`` (default the card).

    ``kernel``, ``sigma`` and ``jitter`` are the reference's
    ``BaseKernel`` fields; ``squeeze`` its flag for 1-D regression
    targets; ``lam`` the fit's ridge.
    """
    dev = _device.resolve(device)
    classes = arrays.get("classes")
    leaf_lo = arrays.get("leaf_lo")
    factors = factors_from_arrays(arrays, dev)
    inverse = inverse_from_arrays(arrays, dev)
    return HCKRegressor(
        BaseKernel(kernel, sigma=sigma, jitter=jitter), factors,
        plan_from_arrays(arrays, dev), _tensor(arrays["alpha"], dev),
        None if classes is None else _tensor(classes, dev),
        squeeze=squeeze, solve_config=solve_config, lam=lam,
        base_leaf_size=None if inverse is None else factors.leaf_size,
        inverse=inverse,
        leaf_lo=None if leaf_lo is None else _tensor(leaf_lo, dev))
